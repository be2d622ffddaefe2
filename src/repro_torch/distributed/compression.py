"""Gradient compression for bandwidth-bound reductions.

Two mechanisms, as in the JAX package:

* ``compressed_psum`` — a collective: reduce-scatter at full (or bf16)
  precision for exact summation, then int8-quantize the *scattered*
  shard and all-gather it compressed.  Per-rank bytes vs a plain f32
  all-reduce (ring): RS_f32 + AG_int8 = 1.25 x size vs 2 x size.

* ``ef_quantize`` — error-feedback int8 quantize/dequantize used as a
  ``grad_transform`` hook in the train step.  Under a mesh the grads are
  blocks; given their specs, each leaf's scale comes from its global
  absmax (a ``pmax`` over the axes it is sharded on), so the result is
  the JAX package's on the global leaf, block by block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tree as T
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import axes_of


def _quantize_int8(x: torch.Tensor, absmax=None):
    absmax = x.abs().max() if absmax is None else absmax
    scale = absmax / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_int8(q: torch.Tensor, scale) -> torch.Tensor:
    return q.float() * scale


def compressed_psum_local(x: torch.Tensor, axis, mesh, *,
                          rs_dtype=torch.float32) -> torch.Tensor:
    """The sum over ``axis`` of the ranks' ``x`` (same shape on every
    rank), through an exact reduce-scatter in ``rs_dtype`` and an int8
    all-gather with one scale per shard.  Returns the (replicated) sum in
    ``x``'s dtype."""
    n = C.axis_size(axis, mesh)
    flat = x.reshape(-1).to(rs_dtype)
    pad = (-flat.shape[0]) % n
    flat = F.pad(flat, (0, pad))
    shard = C.psum_scatter(flat, axis, mesh, dim=0, tiled=True)
    q, scale = _quantize_int8(shard.float())
    q_all = C.all_gather(q, axis, mesh, dim=0, tiled=True)       # int8 bytes
    s_all = C.all_gather(scale.reshape(()), axis, mesh, dim=0)   # n scalars
    idx = torch.arange(n, device=x.device).repeat_interleave(shard.shape[0])
    full = q_all.float() * s_all[idx]
    full = full[: flat.shape[0] - pad] if pad else full
    return full.reshape(x.shape).to(x.dtype)


def compressed_psum(tree, mesh, axis: str = "pod", *,
                    rs_dtype=torch.float32):
    """``compressed_psum_local`` leaf by leaf: each rank's tree in, the
    sum over ``axis`` out (the JAX package replicates its input along
    ``axis``; here each rank brings its own)."""
    return T.map_with_path(
        lambda _, x: compressed_psum_local(x, axis, mesh, rs_dtype=rs_dtype),
        tree)


# ---------------------------------------------------------------------------
# Error-feedback quantization (train-step grad_transform hook)
# ---------------------------------------------------------------------------


def make_ef_state(params):
    return T.map_with_path(
        lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device), params)


def _spec_at(specs, path):
    node = specs
    for k in path:
        node = node[k]
    return node


def ef_quantize(grads, ef_state=None, *, specs=None, par=None):
    """int8 quantize/dequantize with error feedback.

    Returns (compressed_grads, new_ef_state).  With ef_state=None behaves
    as stateless quantization.  ``specs`` / ``par``: the grads are blocks
    under these specs (the sharded train step's), and each leaf's absmax
    is taken over its global leaf."""

    def one(path, g, e=None):
        x = g.float() + (e if e is not None else 0.0)
        absmax = None
        if par is not None and par.mesh is not None:
            axes = tuple(a for entry in _spec_at(specs, path)
                         for a in axes_of(entry))
            absmax = x.abs().max()
            if axes:
                names = tuple(a for a in par.axes if a in axes)
                absmax = C.pmax(absmax, names, par.mesh)
        q, s = _quantize_int8(x, absmax)
        deq = _dequantize_int8(q, s)
        return deq.to(g.dtype), x - deq

    if ef_state is None:
        return T.map_with_path(lambda p, g: one(p, g)[0], grads), None
    pairs = T.map_with_path(one, grads, ef_state)
    comp = T.map_with_path(lambda _, t: t[0], pairs)
    new_ef = T.map_with_path(lambda _, t: t[1], pairs)
    return comp, new_ef
