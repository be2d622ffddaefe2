"""The port's KV block pools against the JAX package's under one random
sequence of allocations, forks, copy-on-writes and releases: refcounts,
free lists and block contents must stay identical, and the pool must
drain to empty.  The same through the engine's row operations (fork,
reorder, release, speculative snapshot)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import api as japi
from repro.serving import kv_pool as JKP
from repro.serving import kv_quant as JKQ
from repro.serving.engine import DecodeEngine as JEngine
from repro_torch import bridge
from repro_torch.configs.base import ModelConfig
from repro_torch.serving.engine import DecodeEngine
from repro_torch.serving.kv_pool import SCRATCH_BLOCK, KVPool, OutOfBlocks
from repro_torch.serving.kv_quant import QuantKVPool


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _pools(cfg, kind, n_blocks, bs):
    if kind == "none":
        return (JKP.KVPool(cfg, n_blocks, bs),
                KVPool(cfg, n_blocks, bs, device="cpu"))
    return (JKQ.QuantKVPool(cfg, n_blocks, bs, mode=kind),
            QuantKVPool(cfg, n_blocks, bs, mode=kind, device="cpu"))


@pytest.mark.parametrize("kind", ["none", "q8", "q4"])
def test_pool_ops_match_reference(tiny_cfg, kind):
    jp, tp = _pools(tiny_cfg, kind, n_blocks=12, bs=4)
    assert tp.block_bytes() == jp.block_bytes()
    rng = np.random.default_rng(len(kind))
    # fill every block with distinct payloads so CoW copies are visible
    filled = {}
    for name in ("k", "v"):
        jleaves = jax.tree_util.tree_leaves(getattr(jp, name))
        for j, t in zip(jleaves, _leaves(getattr(tp, name))):
            data = rng.integers(0, 100, j.shape).astype(np.asarray(j).dtype)
            t.copy_(torch.from_numpy(data))
            filled.setdefault(name, []).append(jnp.asarray(data))
    jp.adopt(*(jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(getattr(jp, n)), filled[n])
        for n in ("k", "v")))

    owned: list = []
    for _ in range(60):
        op = rng.choice(["alloc", "retain", "release", "cow"])
        if op == "alloc":
            n = int(rng.integers(1, 4))
            if n > tp.free_blocks:
                with pytest.raises(OutOfBlocks):
                    tp.alloc(n)
                continue
            a, b = jp.alloc(n), tp.alloc(n)
            assert a == b
            owned.extend(b)
        elif owned and op == "retain":
            blk = owned[int(rng.integers(len(owned)))]
            jp.retain([blk]), tp.retain([blk])
            owned.append(blk)
        elif owned and op == "release":
            blk = owned.pop(int(rng.integers(len(owned))))
            jp.release([blk]), tp.release([blk])
        elif owned and op == "cow" and tp.free_blocks:
            i = int(rng.integers(len(owned)))
            a, b = jp.cow([owned[i]]), tp.cow([owned[i]])
            assert a == b
            owned[i] = b[0]
        np.testing.assert_array_equal(tp.refcount, jp.refcount)
        assert tp._free == jp._free
    for name in ("k", "v"):
        for j, t in zip(jax.tree_util.tree_leaves(getattr(jp, name)),
                        _leaves(getattr(tp, name))):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tp.cow_copies == jp.cow_copies > 0
    tp.release(owned)
    assert tp.blocks_in_use == 0 and not tp.refcount.any()
    with pytest.raises(ValueError):
        tp.release([owned[0]] if owned else [1])


def _table_refcounts(state) -> dict:
    """Expected refcounts: one reference per (row, owned table slot)."""
    want: dict = {}
    for r in range(state.table.shape[0]):
        for b in state.table[r, :state.n_blocks[r]]:
            if int(b) != SCRATCH_BLOCK:
                want[int(b)] = want.get(int(b), 0) + 1
    return want


@pytest.mark.parametrize("kind", ["none", "q8"])
def test_engine_row_ops_random_stress(tiny_cfg, tok, kind):
    """After any random mix of fork / reorder / release_rows /
    spec_snapshot and its rejection on real block tables, every block's
    refcount equals the live table references to it and the reference
    engine's refcount under the same operations; a drain empties the
    pool."""
    jp = japi.get_model(tiny_cfg).init_params(jax.random.key(5), tiny_cfg)
    kw = dict(max_len=32, eos_id=tok.eos_id, pad_id=tok.pad_id, paged=True,
              block_size=8, n_blocks=64, kv_quant=kind)
    jeng = JEngine(jp, tiny_cfg, **kw)
    teng = DecodeEngine(
        bridge.params_from_jax(jax.device_get(jp), device="cpu"),
        ModelConfig(**{f: getattr(tiny_cfg, f) for f in (
            "name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
            "vocab_size", "dtype", "param_dtype")}), **kw)
    prompt = tok.encode("Q:2+7=?A:")
    padded = np.full((2, 16), tok.pad_id, np.int32)
    padded[:, :len(prompt)] = prompt
    lens = np.full((2,), len(prompt), np.int32)
    jst = jeng.prefill(jnp.asarray(padded), jnp.asarray(lens))
    st = teng.prefill(torch.from_numpy(padded), torch.from_numpy(lens))
    rng = np.random.default_rng(7)
    for _ in range(60):
        batch = st.table.shape[0]
        op = rng.choice(["fork", "reorder", "release", "spec"])
        if op == "fork" and batch <= 8:
            jst, st = jeng.fork(jst, 2), teng.fork(st, 2)
        elif op == "reorder":
            idx = rng.integers(0, batch, size=batch)
            jst = jeng.reorder(jst, jnp.asarray(idx, jnp.int32))
            st = teng.reorder(st, idx)
        elif op == "release":
            r = int(rng.integers(batch))
            keep = [i for i in range(batch) if i != r]
            jst, st = jeng.release_rows(jst, [r]), teng.release_rows(st, [r])
            if not keep:
                break
            # drop the released row from the live set
            jst = jeng.reorder(jst, jnp.asarray(keep, jnp.int32))
            st = teng.reorder(st, keep)
        elif op == "spec":
            rows = [int(rng.integers(batch))]
            # the verify rejected the draft lane: its snapshot is released
            jeng.release_rows(jeng.spec_snapshot(jst, rows), rows)
            teng.release_rows(teng.spec_snapshot(st, rows), rows)
        want = _table_refcounts(st)
        for b in range(teng.pool.n_blocks):
            assert teng.pool.refcount[b] == want.get(b, 0), \
                f"block {b}: refcount {teng.pool.refcount[b]} != " \
                f"{want.get(b, 0)} table refs"
        np.testing.assert_array_equal(teng.pool.refcount, jeng.pool.refcount)
    teng.release_rows(st, list(range(st.table.shape[0])))
    assert teng.pool.blocks_in_use == 0
