"""The split-KV algebra of the paged-attention kernel, in plain PyTorch.

The kernel splits a row's table into S fixed ranges.  Split s starts its
LUT recurrence (paper Alg. 1) from m = the maximum of the fp16 block maxima
before its range (a max rounds nothing, so this is the sequential running
max), with l = 0 and acc = 0, keeps C_s, the f32 product of its corr
values, and the splits fold in order as acc <- acc * C_s + acc_s (and the
same for l).  Every p and corr is then the sequential recurrence's fp16
value; only f32 sums are reassociated.  This file writes that algebra out
and holds it against the sequential plain version and the JAX package's
``quant_paged_attention`` (interpret mode) before any card runs it.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import paged_attention as JPA
from repro.serving import kv_quant as JKQ
from repro_torch.kernels import ops, ref

SPLITS = [1, 2, 4, 8, 16]


def split_lut_attention(q, k_pool, v_pool, table, lengths, lut, *,
                        window: int, splits: int):
    """The kernel's split/fold of the fp16 LUT recurrence (exact
    arithmetic of each step as in ``ref.lut_paged_decode_attention_ref``).
    Split s covers table entries [s * per, (s + 1) * per), per =
    ceil(W / splits); entries outside a row's live range are fully masked
    and change nothing (m stays, corr = LUT(0) = 1, p = 0)."""
    B, Hkv, G, D = q.shape
    W = table.shape[1]
    scale = 1.0 / math.sqrt(D)
    qf = q.float()
    lengths = lengths.long()
    s16, vals = [], []
    for j in range(W):  # masked fp16 scores and fp16 V of every block
        kj = ref.gather_blocks(k_pool, table[:, j].long())
        vj = ref.gather_blocks(v_pool, table[:, j].long())
        bs = kj.shape[1]
        s = torch.einsum("bhgd,bshd->bhgs", qf, kj) * scale
        pos = j * bs + torch.arange(bs)
        valid = ref._valid(lengths, pos, window)[:, None, None, :]
        s16.append((torch.where(valid, s, ref.NEG_CAP).to(torch.float16),
                    valid))
        vals.append(vj.to(torch.float16).float())
    bmax = torch.stack([s.amax(dim=-1, keepdim=True) for s, _ in s16])
    per = -(-W // splits)
    acc = torch.zeros((B, Hkv, G, D))
    l = torch.zeros((B, Hkv, G, 1))
    for sp in range(splits):
        j0, j1 = min(W, sp * per), min(W, (sp + 1) * per)
        m = torch.full((B, Hkv, G, 1), ref.NEG_CAP, dtype=torch.float16)
        if j0 > 0:  # the running max entering the split
            m = torch.maximum(m, bmax[:j0].amax(dim=0))
        acc_s = torch.zeros_like(acc)
        l_s = torch.zeros_like(l)
        c_s = torch.ones_like(l)
        for j in range(j0, j1):
            sj, valid = s16[j]
            m_new = torch.maximum(m, bmax[j])
            p = ref.lut_exp(lut, sj - m_new)
            corr = ref.lut_exp(lut, m - m_new).float()
            p = torch.where(valid, p, torch.zeros_like(p)).float()
            l_s = l_s * corr + p.sum(dim=-1, keepdim=True)
            acc_s = acc_s * corr + torch.einsum("bhgs,bshd->bhgd", p,
                                                vals[j])
            c_s = c_s * corr
            m = m_new
        acc = acc * c_s + acc_s
        l = l * c_s + l_s
    return (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)


def _case(kind: str, seed: int, D: int = 32, exact_scores: bool = False):
    """Ragged rows on a 16-block table: one empty, one full, and rows whose
    live blocks start mid-table under a window (numpy inputs, JAX-quantized
    pools).  ``exact_scores``: q in {-1, 0, 1} and D = 16, one scale group
    per K row, so every partial sum of q.k is a small integer times that
    scale and exact in f32: the scores, and so their fp16 rounding, do not
    depend on the order in which a framework sums them."""
    B, Hkv, G, bs, W = 5, 2, 3, 4, 16
    nb = 1 + B * W
    rng = np.random.default_rng(seed)
    if exact_scores:
        q = rng.integers(-1, 2, (B, Hkv, G, D)).astype(np.float32)
    else:
        q = (rng.standard_normal((B, Hkv, G, D)) * 0.5).astype(np.float32)
    pools = []
    for _ in range(2):
        fp = (rng.standard_normal((nb, bs, Hkv, D)) * 0.5).astype(np.float32)
        gr, gc = JKQ.kv_tile_geometry(Hkv, D)
        qd = JKQ.quantize_kv(jnp.asarray(fp), mode=kind, gr=gr, gc=gc)
        pools.append({k: np.asarray(v) for k, v in qd.items()})
    lens = np.array([0, W * bs, 23, 41, 7], np.int32)
    table = np.zeros((B, W), np.int32)
    avail = list(range(1, nb))
    for b in range(B):
        n = -(-int(lens[b]) // bs)
        table[b, :n] = [avail.pop(rng.integers(len(avail))) for _ in range(n)]
    return q, pools[0], pools[1], table, lens


def _t(x):
    if isinstance(x, dict):
        return {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("kind", ["q8", "q4"])
@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("splits", SPLITS)
def test_split_fold_equals_sequential_lut_recurrence(kind, window, splits):
    q, kp, vp, table, lens = _case(kind, seed=len(kind) + window)
    args = (_t(q), _t(kp), _t(vp), _t(table), _t(lens), ops.exp_lut())
    want = ref.lut_paged_decode_attention_ref(*args, window=window)
    got = split_lut_attention(*args, window=window, splits=splits)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    assert float(got[0].abs().max()) == 0.0  # zero-length row


@pytest.mark.parametrize("kind", ["q8", "q4"])
@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("splits", SPLITS)
def test_split_fold_equals_jax_quant_paged_attention(kind, window, splits):
    """Against the JAX kernel the scores must not depend on summation order
    (JAX and PyTorch sum q.k differently, and one flipped fp16 score moves
    the output by ~1e-4), hence exactly representable scores."""
    q, kp, vp, table, lens = _case(kind, seed=10 + len(kind) + window, D=16,
                                   exact_scores=True)
    want = np.asarray(JPA.quant_paged_attention(
        jnp.asarray(q), {k: jnp.asarray(v) for k, v in kp.items()},
        {k: jnp.asarray(v) for k, v in vp.items()}, jnp.asarray(table),
        jnp.asarray(lens), jops.exp_lut(), window=window, exp_mode="lut"))
    args = (_t(q), _t(kp), _t(vp), _t(table), _t(lens), ops.exp_lut())
    got = split_lut_attention(*args, window=window, splits=splits)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
