"""The tensor-core K5 kernel's schedule, modelled in plain PyTorch on the
CPU, against the plain version and the JAX package's Pallas kernel.

``csrc/lut_softmax_attention.cu`` runs one thread block per (head, 64
query rows), a warp per 16 rows, and pads each KV block of ``bkv`` rows to
the mma's k step of 16: the padded K rows hold whatever shared memory held
(here NaN), the padded V rows are zero, the padded columns enter neither
the row max nor l and give p = 0 exactly.  A causal warp stops at the last
block, and within it at the last 16-column step, that its rows can see.
:func:`tiled_flash` does the same arithmetic in that order.  Since the
padding adds only exact zeros and a skipped step is one the mask covers
(p = 0, corr = 1), it agrees with ``ref.lut_flash_attention_ref`` to
1e-6; against the Pallas kernel (interpret mode) the bar is the JAX
package's kernel bar, 2e-3.  The CUDA kernel itself is held against the
plain version on the card (``test_torch_cuda.py``)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lut_softmax_attention import build_exp_lut as jax_lut
from repro.kernels.lut_softmax_attention import \
    lut_softmax_attention as jax_kernel
from repro_torch.kernels import ops, ref

NEG_CAP = ref.NEG_CAP
CTA_ROWS, WARP_ROWS, K_STEP = 64, 16, 16


def tiled_flash(q, k, v, lut, *, causal, bkv, exp_mode, kv_group):
    """K5's schedule over (BH, Sq, D) fp16 q and (BH / G, Skv, D) k, v."""
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    nkt = -(-bkv // K_STEP)
    pad = nkt * K_STEP - bkv
    scale = 1.0 / math.sqrt(D)
    n_cta = -(-Sq // CTA_ROWS)
    # query rows padded with zeros to whole thread blocks
    qp = torch.zeros((BH, n_cta * CTA_ROWS, D), dtype=torch.float16)
    qp[:, :Sq] = q
    out = torch.empty_like(q)
    for bh in range(BH):
        kh, vh = k[bh // kv_group], v[bh // kv_group]
        for r0 in range(0, n_cta * CTA_ROWS, WARP_ROWS):
            last = min(r0 + WARP_ROWS - 1, Sq - 1)
            if last < r0:
                continue  # a warp with no rows
            qf = qp[bh, r0:r0 + WARP_ROWS].float()
            qpos = torch.arange(r0, r0 + WARP_ROWS)[:, None]
            m = torch.full((WARP_ROWS, 1), NEG_CAP, dtype=torch.float16)
            l = torch.zeros((WARP_ROWS, 1))
            acc = torch.zeros((WARP_ROWS, D))
            for kv0 in range(0, Skv, bkv):
                if causal and kv0 > last:
                    break
                nkt_w = min(nkt, (last - kv0) // K_STEP + 1) if causal \
                    else nkt
                cols = nkt_w * K_STEP
                kt = torch.cat([kh[kv0:kv0 + bkv],
                                torch.full((pad, D), float("nan"),
                                           dtype=torch.float16)])[:cols]
                vt = torch.cat([vh[kv0:kv0 + bkv],
                                torch.zeros((pad, D), dtype=torch.float16)
                                ])[:cols]
                s = (qf @ kt.float().T) * scale
                kpos = kv0 + torch.arange(cols)[None]
                if causal:
                    s = torch.where(kpos <= qpos, s, NEG_CAP)
                s16 = s.to(torch.float16)
                real = (torch.arange(cols) < bkv)[None]
                mx = torch.where(real, s16, NEG_CAP).amax(-1, keepdim=True)
                m_new = torch.maximum(m, mx)
                p = ref._exp16(s16 - m_new, lut, exp_mode)
                p = torch.where(real, p, torch.zeros_like(p))
                corr = ref._exp16(m - m_new, lut, exp_mode).float()
                l = l * corr + p.float().sum(-1, keepdim=True)
                acc = acc * corr + p.float() @ vt.float()
                m = m_new
            o = (acc / torch.clamp_min(l, 1e-30)).to(torch.float16)
            n = min(WARP_ROWS, Sq - r0)
            out[bh, r0:r0 + n] = o[:n]
    return out


# (BH, Sq, Skv, D, kv_group, causal, bkv): KV blocks of 79, 100 and 96
# rows (not multiples of 16), 8 and 79 query rows (less than a warp's and
# a block's rows), head_dim 32 / 64 / 128, G 1 / 3 / 6, causal with
# Sq < Skv (top-left), and 130 rows over three thread blocks
CASES = [(6, 79, 79, 32, 3, True, 79), (6, 8, 200, 64, 6, False, 100),
         (2, 48, 192, 128, 1, True, 96), (3, 79, 237, 64, 3, True, 79),
         (2, 130, 200, 32, 1, True, 100)]


def _inputs(BH, Sq, Skv, D, G, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((BH, Sq, D)) * 0.5).astype(np.float16)
    k, v = ((rng.standard_normal((BH // G, Skv, D)) * 0.5).astype(np.float16)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("exp_mode", ["lut", "poly", "exact"])
@pytest.mark.parametrize("case", CASES)
def test_tiled_schedule_matches_plain_and_jax(case, exp_mode):
    BH, Sq, Skv, D, G, causal, bkv = case
    q, k, v = _inputs(BH, Sq, Skv, D, G, seed=sum(case))
    kw = dict(causal=causal, bkv=bkv, exp_mode=exp_mode, kv_group=G)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    got = tiled_flash(qt, kt, vt, ops.exp_lut(), **kw)
    plain = ref.lut_flash_attention_ref(qt, kt, vt, ops.exp_lut(), **kw)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), plain.float(), atol=1e-6, rtol=0)
    want = np.asarray(jax_kernel(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), G, axis=0),
        jnp.repeat(jnp.asarray(v), G, axis=0), jax_lut(), causal=causal,
        bq=Sq, bkv=bkv, exp_mode=exp_mode), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-3, rtol=0)


def test_padded_columns_are_not_masked_columns():
    """A padded column gives p = 0, not exp(NEG_CAP - m): while m is still
    NEG_CAP (a row that sees nothing yet) the two differ, which is why the
    kernel drops padded columns by position and not through the mask."""
    lut = ops.exp_lut()
    m = torch.tensor([[NEG_CAP]], dtype=torch.float16)
    s16 = torch.tensor([[NEG_CAP]], dtype=torch.float16)
    for mode in ("lut", "poly", "exact"):
        assert float(ref._exp16(s16 - m, lut, mode)) == 1.0
