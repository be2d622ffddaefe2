"""The port's KV block pools against the JAX package's under one random
sequence of allocations, forks, copy-on-writes and releases: refcounts,
free lists and block contents must stay identical, and the pool must
drain to empty."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import kv_pool as JKP
from repro.serving import kv_quant as JKQ
from repro_torch.serving.kv_pool import KVPool, OutOfBlocks
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
