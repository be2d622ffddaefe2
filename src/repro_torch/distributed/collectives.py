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
``reduce-scatter``, :func:`regroup` -> ``collective-permute``).  The
backward of a differentiable primitive is its transpose and is recorded
as such.  An installed recorder also counts the collectives a real mesh
performs, by the same names.
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


_CALLS = None  # a list of (kind, axes, operand shape) while recording


@contextlib.contextmanager
def record_collectives(calls: list = None):
    """Count the collectives issued in the block: yields {kind: {"count",
    "bytes"}}, the bytes being each result's (per rank), as the dry-run
    of the JAX package parses them from the compiled HLO.  ``calls``, if
    given, receives (kind, axes, the operand's shape, the bytes counted)
    per call (a block that gives none keeps an enclosing block's list)."""
    global _RECORDER, _CALLS
    prev, _RECORDER = _RECORDER, {}
    prev_calls, _CALLS = _CALLS, (_CALLS if calls is None else calls)
    try:
        yield _RECORDER
    finally:
        _RECORDER, _CALLS = prev, prev_calls


def _record(kind: str, result: torch.Tensor, nbytes: int = None,
            axis=None, operand=None) -> None:
    if nbytes is None:
        nbytes = result.numel() * result.element_size()
    if _RECORDER is not None:
        d = _RECORDER.setdefault(kind, {"count": 0, "bytes": 0})
        d["count"] += 1
        d["bytes"] += nbytes
    if _CALLS is not None:
        _CALLS.append((kind, axes_of(axis), tuple(
            (result if operand is None else operand).shape), nbytes))


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
    _record("all-reduce", y, axis=axis)
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
    _record("all-gather", out, axis=axis, operand=x)
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
    _record("reduce-scatter", out, axis=axis, operand=x)
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


# ---------------------------------------------------------------------------
# Regrouping a split dim: point-to-point pieces between the ranks of an axis
# ---------------------------------------------------------------------------


def _send_recv(sends, recvs, axis, mesh):
    """Point-to-point exchange along ``axis``: ``sends`` [(peer index,
    tensor)], ``recvs`` [(peer index, shape, dtype, device)]; returns the
    received tensors in ``recvs``' order.  All posted, then awaited."""
    g = group(axis, mesh)
    ranks = dist.get_process_group_ranks(g)
    staged = any(t.is_cuda for _, t in sends) or any(
        torch.device(d).type == "cuda" for *_, d in recvs)
    staged = staged and dist.get_backend(g) == "gloo"
    host = "cpu" if staged else None
    works, outs = [], []
    for peer, shape, dtype, device in recvs:
        buf = torch.empty(shape, dtype=dtype, device=host or device)
        works.append(dist.irecv(buf, src=ranks[peer], group=g))
        outs.append(buf)
    for peer, t in sends:
        t = t.detach().contiguous()
        works.append(dist.isend(t.cpu() if staged else t, dst=ranks[peer],
                                group=g))
    for w in works:
        w.wait()
    return [o.to(d) if staged else o
            for o, (*_, d) in zip(outs, recvs)]


def _pieces(have, want, me: int, n: int):
    """The overlaps [lo, hi) of ``want[me]`` with each rank's ``have``
    (what ``me`` receives, by source) and of each rank's ``want`` with
    ``have[me]`` (what it sends, by destination)."""
    def cut(a, b):
        lo, hi = max(a[0], b[0]), min(a[1], b[1])
        return (lo, hi) if hi > lo else None

    got = [(t, c) for t in range(n) if (c := cut(want[me], have[t]))]
    give = [(s, c) for s in range(n) if s != me
            and (c := cut(want[s], have[me]))]
    return got, give


def _regroup(x, have, want, axis, mesh, dim):
    n = axis_size(axis, mesh)
    me = axis_index(axis, mesh)
    got, give = _pieces(have, want, me, n)
    h0 = have[me][0]

    def part(lo, hi):
        return x.narrow(dim, lo - h0, hi - lo)

    shape = list(x.shape)
    recvs = []
    for t, (lo, hi) in got:
        if t != me:
            shape[dim] = hi - lo
            recvs.append((t, tuple(shape), x.dtype, x.device))
    if _abstract(x, mesh):
        received = [torch.empty(s, dtype=d, device="meta")
                    for _, s, d, _ in recvs]
    elif recvs or give:
        received = _send_recv([(s, part(lo, hi)) for s, (lo, hi) in give],
                              recvs, axis, mesh)
    else:
        received = []
    it = iter(received)
    out = torch.cat([part(lo, hi) if t == me else next(it)
                     for t, (lo, hi) in got], dim=dim) if got else \
        x.new_empty(shape[:dim] + [0] + shape[dim + 1:])
    nbytes = sum(r.numel() * r.element_size() for r in received)
    if received or give:
        _record("collective-permute", out, nbytes, axis=axis, operand=x)
    return out


def _unregroup(g, x_shape, have, want, axis, mesh, dim):
    """The transpose of :func:`_regroup`: each received piece's grad goes
    back to its source and is summed there with the others'."""
    n = axis_size(axis, mesh)
    me = axis_index(axis, mesh)
    got, give = _pieces(have, want, me, n)
    w0, h0 = want[me][0], have[me][0]
    gx = g.new_zeros(x_shape)
    sends, own = [], None
    for t, (lo, hi) in got:
        piece = g.narrow(dim, lo - w0, hi - lo)
        if t == me:
            own = (lo, piece)
        else:
            sends.append((t, piece))
    shape = list(x_shape)
    recvs = []
    for s, (lo, hi) in give:
        shape[dim] = hi - lo
        recvs.append((s, tuple(shape), g.dtype, g.device))
    if _abstract(g, mesh):
        received = [torch.empty(sh, dtype=d, device="meta")
                    for _, sh, d, _ in recvs]
    elif recvs or sends:
        received = _send_recv(sends, recvs, axis, mesh)
    else:
        received = []
    if own is not None:
        lo, piece = own
        gx.narrow(dim, lo - h0, piece.shape[dim]).add_(piece)
    for (s, (lo, hi)), r in zip(give, received):
        gx.narrow(dim, lo - h0, hi - lo).add_(r)
    nbytes = sum(r.numel() * r.element_size() for r in received)
    if received or sends:
        _record("collective-permute", gx, nbytes, axis=axis, operand=g)
    return gx


class _Regroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, have, want, axis, mesh, dim):
        ctx.args = (tuple(x.shape), have, want, axis, mesh, dim)
        return _regroup(x, have, want, axis, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return (_unregroup(g, *ctx.args), None, None, None, None, None)


def regroup(x: torch.Tensor, have, want, axis, mesh, *,
            dim: int = -1) -> torch.Tensor:
    """Move pieces of a dim split over ``axis`` between its ranks: rank
    i holds global indices ``have[i]`` = [a, b) of dim ``dim`` (``x``) and
    gets ``want[i]`` = [a', b'), each piece from the ranks that hold it,
    point to point (XLA's ``collective-permute``; recorded with the bytes
    the rank receives).  Ranges may be empty or overlap between ranks.
    Differentiable: the backward returns each piece's grad to its source,
    summed over the ranks that took it."""
    dim = dim % x.dim()
    if axis_size(axis, mesh) == 1:
        return x.narrow(dim, want[0][0] - have[0][0],
                        want[0][1] - want[0][0])
    return _Regroup.apply(x, tuple(have), tuple(want), axis, mesh, dim)
