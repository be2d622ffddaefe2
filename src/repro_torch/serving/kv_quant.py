"""Quantized KV block pool: tile-quantized Q8/Q4 blocks over the paged pool.

The paper's §5.1 tile geometry applied to the KV cache.  One token's
``(Hkv, D)`` slab is written atomically, so groups never span tokens, and
within the slab a group is a ``(gr, gc)`` rectangle of ``gr = 2`` adjacent
KV heads × ``gc = group_size // 2 = 16`` contiguous head dims.  Per leaf
the storage is::

    codes : (L, n_blocks, bs, Hkv, D)      int8          (q8)
            (L, n_blocks, bs, Hkv, D//2)   uint8 packed  (q4, low nibble =
                                                          even dim)
    scales: (L, n_blocks, bs, Hkv//gr, D//gc)  float16

q8 codes are ``clip(round(x/s), -127, 127)`` with ``s = absmax/127``; q4
codes index the ``q4_0`` 16-entry codebook.  An odd ``Hkv`` falls back to
``gr = 1`` and a ``D`` not divisible by 16 halves ``gc`` until it divides.
Shape metadata is recovered from the leaf shapes alone
(:func:`kv_geometry`).  Codes and scales are bit-identical to the JAX
package's ``quantize_kv``.
"""
from __future__ import annotations

import torch

from repro_torch.quant.codebooks import codebook_absmax, get_codebook
from repro_torch.serving.kv_pool import KVPool

# nearest entry of the affine q4_0 grid is a shifted round, which keeps the
# write path cheap
Q4_CODEBOOK = "q4_0"


def kv_tile_geometry(n_kv_heads: int, head_dim: int,
                     group_size: int = 32) -> tuple[int, int]:
    """(gr, gc) tile shape for an ``(Hkv, D)`` token slab."""
    gr = 2 if n_kv_heads % 2 == 0 else 1
    gc = max(1, group_size // 2)
    while head_dim % gc:
        gc //= 2
    return gr, gc


def kv_geometry(leaf: dict) -> tuple[str, int, int, int]:
    """Recover (mode, gr, gc, head_dim) from a quantized leaf's shapes:
    ``codes (..., Hkv, Dc)`` / ``scales (..., Hkv//gr, D//gc)``."""
    codes, scales = leaf["codes"], leaf["scales"]
    mode = "q8" if codes.dtype == torch.int8 else "q4"
    hkv = codes.shape[-2]
    d = codes.shape[-1] * (2 if mode == "q4" else 1)
    return mode, hkv // scales.shape[-2], d // scales.shape[-1], d


def _pack_q4(codes: torch.Tensor) -> torch.Tensor:
    """(..., D) uint8 in [0,15] -> (..., D//2): low nibble = even dim."""
    return codes[..., 0::2] | (codes[..., 1::2] << 4)


def _unpack_q4(packed: torch.Tensor) -> torch.Tensor:
    """(..., D//2) uint8 -> (..., D) uint8 in [0,15]."""
    return torch.stack([packed & 0xF, packed >> 4], dim=-1).reshape(
        *packed.shape[:-1], packed.shape[-1] * 2)


def _tile_scales(x: torch.Tensor, gr: int, gc: int) -> torch.Tensor:
    """Per-(gr, gc)-tile absmax of (..., H, D) -> (..., H//gr, D//gc)."""
    *lead, H, D = x.shape
    t = x.reshape(*lead, H // gr, gr, D // gc, gc)
    return t.abs().amax(dim=(-3, -1))


def _broadcast_scales(scales: torch.Tensor, gr: int, gc: int):
    """(..., H//gr, D//gc) -> (..., H, D): the two cheap repeats."""
    return scales.repeat_interleave(gr, dim=-2).repeat_interleave(gc, dim=-1)


def quantize_kv(x: torch.Tensor, *, mode: str, gr: int, gc: int,
                scale_dtype=torch.float16) -> dict:
    """Tile-quantize KV values x: (..., Hkv, D); the trailing two dims are
    one token's slab, leading dims are free.  Returns {"codes", "scales"}
    in the pool leaf layout."""
    if mode not in ("q8", "q4"):
        raise ValueError(f"kv quant mode must be q8 or q4, got {mode!r}")
    xf = x.to(torch.float32)
    qmax = 127.0 if mode == "q8" else codebook_absmax(Q4_CODEBOOK)
    scales = (_tile_scales(xf, gr, gc) / qmax).to(scale_dtype)
    sc = torch.clamp_min(_broadcast_scales(scales.float(), gr, gc), 1e-8)
    wn = xf / sc
    if mode == "q8":
        codes = torch.clamp(torch.round(wn), -127, 127).to(torch.int8)
    else:
        codes = (torch.clamp(torch.round(wn), -8, 7) + 8).to(torch.uint8)
        codes = _pack_q4(codes)
    return {"codes": codes, "scales": scales}


def dequantize_kv(q: dict, *, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`; leading dims are free.  The
    arithmetic is K4's plain version, ``ref.lut_dequant_kv_ref``."""
    from repro_torch.kernels.ref import lut_dequant_kv_ref

    mode, gr, gc, _ = kv_geometry(q)
    cb = (get_codebook(Q4_CODEBOOK, device=q["codes"].device)
          if mode == "q4" else None)
    return lut_dequant_kv_ref(q["codes"], q["scales"], cb, mode=mode,
                              gr=gr, gc=gc).to(dtype)


def quantize_for_pool(x: torch.Tensor, pool_leaf):
    """Quantize ``x`` to match a pool leaf's storage (identity on fp
    pools) — the single write-path hook the scatter sites call."""
    if not isinstance(pool_leaf, dict):
        return x
    mode, gr, gc, _ = kv_geometry(pool_leaf)
    return quantize_kv(x, mode=mode, gr=gr, gc=gc,
                       scale_dtype=pool_leaf["scales"].dtype)


def pool_block_size(pool_leaf, axis: int = 1) -> int:
    """Token block size of a pool leaf (fp tensor or quantized dict):
    ``axis`` 1 of a per-layer (n_blocks, bs, ...) leaf, 2 of a stacked
    (L, n_blocks, bs, ...) one."""
    leaf = pool_leaf["codes"] if isinstance(pool_leaf, dict) else pool_leaf
    return leaf.shape[axis]


class QuantKVPool(KVPool):
    """Refcounted block pool whose blocks store tile-quantized KV.

    Drop-in for :class:`~repro_torch.serving.kv_pool.KVPool`: every
    host-side operation is inherited because blocks move as opaque
    code+scale payloads; only the device storage differs.  ``mode``: "q8"
    (int8 codes) or "q4" (packed q4_0 codes), both with per-(2, 16)-tile
    float16 scales.
    """

    def __init__(self, cfg, n_blocks: int, block_size: int, *,
                 mode: str = "q8", group_size: int = 32,
                 scale_dtype=torch.float16, device):
        if mode not in ("q8", "q4"):
            raise ValueError(f"kv_quant mode must be q8 or q4, got {mode!r}")
        hd = cfg.resolved_head_dim()
        if mode == "q4" and hd % 2:
            raise ValueError(f"q4 KV packing needs an even head_dim "
                             f"(got {hd})")
        self.mode = mode
        self.scale_dtype = scale_dtype
        self.gr, self.gc = kv_tile_geometry(cfg.n_kv_heads, hd, group_size)
        super().__init__(cfg, n_blocks, block_size, device=device)

    def _init_storage(self, cfg, n_blocks: int, block_size: int,
                      dtype) -> dict:
        hd = cfg.resolved_head_dim()
        dc = hd // 2 if self.mode == "q4" else hd
        code_dtype = torch.uint8 if self.mode == "q4" else torch.int8
        cshape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads, dc)
        sshape = (cfg.n_layers, n_blocks, block_size,
                  cfg.n_kv_heads // self.gr, hd // self.gc)

        def leaf():
            return {"codes": torch.zeros(cshape, dtype=code_dtype,
                                         device=self.device),
                    "scales": torch.zeros(sshape, dtype=self.scale_dtype,
                                          device=self.device)}

        return {"k": leaf(), "v": leaf()}
