"""The ``shard_map`` primitives as functions of a mesh axis.

Each takes the rank's tensor, a mesh axis (a name or a tuple of names, in
the mesh's order) and the ``DeviceMesh``, and runs the collective over
the ranks that differ only along those axes: what ``jax.lax.psum(x,
axis)`` and friends do inside a ``shard_map`` body.  A tuple of axes
orders its ranks row-major, as a ``NamedSharding`` orders a dim split
over several axes.

``psum``, ``pmean``, ``psum_scatter`` and ``all_gather`` are
differentiable, each with its transpose as its backward (a sum's is a
sum; a gather's is a reduce-scatter), so the grads of every rank are
those of the sum of all the ranks' losses.  ``pmax`` and ``pmin`` carry
no grad.

Every backend runs the same calls (``all_reduce``, the all-gather and
the reduce-scatter into one tensor).  A ``gloo`` group moves CUDA tensors
through the host: the tensor is copied to the CPU, reduced there and
copied back.  That is how ranks that share one GPU (where NCCL refuses
two ranks on a device) talk; it measures nothing about NVLink.

Under a :class:`~repro_torch.distributed.sharding.AbstractMesh` (the
dry-run) nothing is performed: each primitive takes ``meta`` tensors
(anything else raises), returns an empty ``meta`` tensor of its result's
shape and dtype as rank 0 would get it, and adds (1, the result's bytes)
to the recorder that :func:`record_collectives` installs, under the
names XLA's HLO gives the primitive (``psum`` / ``pmax`` / ``pmin`` ->
``all-reduce``, ``all_gather`` -> ``all-gather``, ``psum_scatter`` ->
``reduce-scatter``).  The backward of a differentiable primitive is its
transpose and is recorded as such.  An installed recorder also counts
the collectives a real mesh performs, by the same names.
"""
from __future__ import annotations

import contextlib
import math
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import axes_of, is_abstract, mesh_shape

_GROUPS: dict = {}
_RECORDER = None  # {kind: {"count", "bytes"}} while record_collectives runs
# torch 2.13 renames the two (and warns on the old names); older releases
# have only the old ones
_all_gather_base = getattr(dist, "all_gather_single",
                           dist.all_gather_into_tensor)
_reduce_scatter_base = getattr(dist, "reduce_scatter_single",
                               dist.reduce_scatter_tensor)


def axis_size(axis, mesh) -> int:
    """Ranks along ``axis`` (the product over a tuple of axes)."""
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in axes_of(axis))


@contextlib.contextmanager
def record_collectives():
    """Count the collectives issued in the block: yields {kind: {"count",
    "bytes"}}, the bytes being each result's (per rank), as the dry-run
    of the JAX package parses them from the compiled HLO."""
    global _RECORDER
    prev, _RECORDER = _RECORDER, {}
    try:
        yield _RECORDER
    finally:
        _RECORDER = prev


def _record(kind: str, result: torch.Tensor) -> None:
    if _RECORDER is not None:
        d = _RECORDER.setdefault(kind, {"count": 0, "bytes": 0})
        d["count"] += 1
        d["bytes"] += result.numel() * result.element_size()


def _abstract(x: torch.Tensor, mesh) -> bool:
    """Whether ``mesh`` is abstract; then ``x`` must be a meta tensor."""
    if not is_abstract(mesh):
        return False
    if x.device.type != "meta":
        raise ValueError(f"a collective under an AbstractMesh takes meta "
                         f"tensors (the dry-run), got one on {x.device}")
    return True


def axis_index(axis, mesh) -> int:
    """This rank's index along ``axis`` (row-major over a tuple); rank
    0's under an AbstractMesh."""
    if is_abstract(mesh):
        return 0
    shape = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    idx = 0
    for a in axes_of(axis):
        idx = idx * shape[a] + coord[a]
    return idx


def group(axis, mesh):
    """The process group of the ranks that differ only along ``axis``.
    One axis: the mesh's own group.  Several: groups built once per mesh
    and axes, by every rank in the same order (``new_group`` is
    collective)."""
    axes = axes_of(axis)
    names = tuple(mesh.mesh_dim_names)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if list(axes) != [a for a in names if a in axes]:
        raise ValueError(f"axes {axes} must follow the mesh's order {names}")
    key = (id(mesh), axes)
    if key not in _GROUPS:
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        n = math.prod(mesh.shape[i] for i in dims)
        rows = mesh.mesh.permute(rest + dims).reshape(-1, n).tolist()
        me, mine = dist.get_rank(), None
        for row in rows:
            if row != sorted(row):
                raise ValueError("the mesh's ranks must rise row-major")
            g = dist.new_group(row)
            if me in row:
                mine = g
        _GROUPS[key] = (mesh, mine)  # the mesh kept alive with its id
    return _GROUPS[key][1]


def _staged(x: torch.Tensor, g) -> bool:
    return x.is_cuda and dist.get_backend(g) == "gloo"


def _all_reduce(x, op, axis, mesh):
    if _abstract(x, mesh):
        y = torch.empty_like(x.detach())
    else:
        g = group(axis, mesh)
        staged = _staged(x, g)
        y = x.detach().to("cpu", copy=True) if staged else x.detach().clone()
        dist.all_reduce(y, op=op, group=g)
        y = y.to(x.device) if staged else y
    _record("all-reduce", y)
    return y


def _gather0(x, n, g):
    staged = _staged(x, g)
    src = x.detach().contiguous()
    src = src.cpu() if staged else src
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    _all_gather_base(out, src, group=g)
    return out.to(x.device) if staged else out


def _scatter0(x, n, g):
    staged = _staged(x, g)
    src = x.detach().contiguous()
    src = src.cpu() if staged else src
    if src.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(src.shape)} does not split {n} "
                         f"ways")
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    _reduce_scatter_base(out, src, group=g)
    return out.to(x.device) if staged else out


def _gather_dim(x, axis, mesh, dim):
    n = axis_size(axis, mesh)
    if _abstract(x, mesh):
        shape = list(x.shape)
        shape[dim] *= n
        out = x.new_empty(shape)
    else:
        out = _gather0(x.movedim(dim, 0), n,
                       group(axis, mesh)).movedim(0, dim)
    _record("all-gather", out)
    return out


def _scatter_dim(x, axis, mesh, dim):
    n = axis_size(axis, mesh)
    if _abstract(x, mesh):
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"{n} ways")
        shape = list(x.shape)
        shape[dim] //= n
        out = x.new_empty(shape)
    else:
        out = _scatter0(x.movedim(dim, 0), n,
                        group(axis, mesh)).movedim(0, dim)
    _record("reduce-scatter", out)
    return out


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.args = (axis, mesh)
        return _all_reduce(x, dist.ReduceOp.SUM, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        axis, mesh = ctx.args
        return _all_reduce(g, dist.ReduceOp.SUM, axis, mesh), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, dim):
        ctx.args = (axis, mesh, dim)
        return _gather_dim(x, axis, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_dim(g, *ctx.args), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, dim):
        ctx.args = (axis, mesh, dim)
        return _scatter_dim(x, axis, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, *ctx.args), None, None, None


def psum(x: torch.Tensor, axis, mesh) -> torch.Tensor:
    """Sum over the ranks along ``axis`` (in ``x``'s dtype)."""
    if axis_size(axis, mesh) == 1:
        return x
    return _Sum.apply(x, axis, mesh)


def pmean(x: torch.Tensor, axis, mesh) -> torch.Tensor:
    return psum(x, axis, mesh) / axis_size(axis, mesh)


def pmax(x: torch.Tensor, axis, mesh) -> torch.Tensor:
    if axis_size(axis, mesh) == 1:
        return x.detach()
    return _all_reduce(x, dist.ReduceOp.MAX, axis, mesh)


def pmin(x: torch.Tensor, axis, mesh) -> torch.Tensor:
    if axis_size(axis, mesh) == 1:
        return x.detach()
    return _all_reduce(x, dist.ReduceOp.MIN, axis, mesh)


def psum_scatter(x: torch.Tensor, axis, mesh, *, dim: int = 0,
                 tiled: bool = True) -> torch.Tensor:
    """Sum over ``axis``, each rank keeping its 1/n of dim ``dim``
    (``tiled``); untiled, dim ``dim`` has size n and is dropped."""
    n = axis_size(axis, mesh)
    if not tiled and x.shape[dim] != n:
        raise ValueError(f"untiled psum_scatter needs dim {dim} of size {n}")
    y = x if n == 1 else _Scatter.apply(x, axis, mesh, dim)
    return y if tiled else y.squeeze(dim)


def all_gather(x: torch.Tensor, axis, mesh, *, dim: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """The ranks' tensors along ``axis`` in rank order: concatenated on
    dim ``dim`` (``tiled``) or stacked on a new dim ``dim``."""
    if not tiled:
        x = x.unsqueeze(dim)
    if axis_size(axis, mesh) == 1:
        return x
    return _Gather.apply(x, axis, mesh, dim)
