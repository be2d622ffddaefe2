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
shape and dtype as the mesh's rank (rank 0 unless its ``coordinate``
names another) would get it, and adds (1, the result's bytes)
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
import numbers

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
    """This rank's index along ``axis`` (row-major over a tuple); under an
    AbstractMesh that of its ``coordinate`` (rank 0's unless given)."""
    shape = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.coordinate if
                     is_abstract(mesh) else mesh.get_coordinate()))
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


def _ranges(entry) -> tuple:
    """A rank's ranges of a regrouped dim, in the order its tensor holds
    them: one [a, b) given as (a, b), or a tuple of such pairs."""
    if len(entry) == 2 and all(isinstance(v, numbers.Integral)
                               for v in entry):
        return ((int(entry[0]), int(entry[1])),)
    return tuple((int(a), int(b)) for a, b in entry)


def _local(ranges: tuple, lo: int) -> int:
    """Where global index ``lo`` sits in the concatenation of ``ranges``."""
    pos = 0
    for a, b in ranges:
        if a <= lo < b:
            return pos + lo - a
        pos += b - a
    raise ValueError(f"index {lo} is outside {ranges}")


def _pieces(have, want, me: int, n: int):
    """What ``me`` receives, [(source, lo, hi)] in the order of its output
    (its ``want`` ranges in turn, each one's pieces by lo), and what it
    sends, {destination: [(lo, hi)]} in the order that rank receives them
    from ``me``.  Each rank's ``have`` ranges are disjoint from the
    others'."""
    def cut(w, t):
        out = []
        for a, b in have[t]:
            lo, hi = max(w[0], a), min(w[1], b)
            if hi > lo:
                out.append((lo, hi))
        return sorted(out)

    got = []
    for w in want[me]:
        got += sorted(((t, lo, hi) for t in range(n) for lo, hi in cut(w, t)),
                      key=lambda p: p[1])
    give = {}
    for s in range(n):
        pcs = [c for w in want[s] for c in cut(w, me)] if s != me else []
        if pcs:
            give[s] = pcs
    return got, give


def _exchange(pieces, recvs, abstract: bool, axis, mesh, dim):
    """One message per peer: ``pieces`` {peer: [tensor, ...]} sent
    concatenated along ``dim``; the received tensors in ``recvs``' order
    (under an AbstractMesh empty ``meta`` tensors, nothing sent)."""
    if abstract:
        return [torch.empty(s, dtype=d, device="meta")
                for _, s, d, _ in recvs]
    sends = [(p, ts[0] if len(ts) == 1 else torch.cat(ts, dim=dim))
             for p, ts in pieces.items()]
    if recvs or sends:
        return _send_recv(sends, recvs, axis, mesh)
    return []


def _regroup(x, have, want, axis, mesh, dim):
    n = axis_size(axis, mesh)
    me = axis_index(axis, mesh)
    got, give = _pieces(have, want, me, n)
    hv = have[me]

    def part(lo, hi):
        return x.narrow(dim, _local(hv, lo), hi - lo)

    lens: dict = {}
    for t, lo, hi in got:
        if t != me:
            lens[t] = lens.get(t, 0) + hi - lo
    shape = list(x.shape)
    recvs = []
    for t, k in lens.items():
        shape[dim] = k
        recvs.append((t, tuple(shape), x.dtype, x.device))
    abstract = _abstract(x, mesh)
    received = _exchange({} if abstract else {
        s: [part(lo, hi) for lo, hi in pcs] for s, pcs in give.items()},
        recvs, abstract, axis, mesh, dim)
    chunks = {t: list(r.split([hi - lo for s, lo, hi in got if s == t],
                              dim=dim))
              for (t, *_), r in zip(recvs, received)}
    shape[dim] = 0
    out = torch.cat([part(lo, hi) if t == me else chunks[t].pop(0)
                     for t, lo, hi in got], dim=dim) if got else \
        x.new_empty(shape)
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
    hv = have[me]
    gx = g.new_zeros(x_shape)
    own, back, pos = [], {}, 0
    for t, lo, hi in got:
        piece = g.narrow(dim, pos, hi - lo)
        pos += hi - lo
        if t == me:
            own.append((lo, piece))
        else:
            back.setdefault(t, []).append(piece)
    shape = list(x_shape)
    recvs = []
    for s, pcs in give.items():
        shape[dim] = sum(hi - lo for lo, hi in pcs)
        recvs.append((s, tuple(shape), g.dtype, g.device))
    received = _exchange(back, recvs, _abstract(g, mesh), axis, mesh, dim)
    for lo, piece in own:
        gx.narrow(dim, _local(hv, lo), piece.shape[dim]).add_(piece)
    for (s, pcs), r in zip(give.items(), received):
        for (lo, hi), piece in zip(pcs, r.split([hi - lo for lo, hi in pcs],
                                                dim=dim)):
            gx.narrow(dim, _local(hv, lo), hi - lo).add_(piece)
    nbytes = sum(r.numel() * r.element_size() for r in received)
    if received or back:
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
    i holds global indices ``have[i]`` of dim ``dim`` (``x``) and gets
    ``want[i]``, each piece from the ranks that hold it, point to point
    (XLA's ``collective-permute``; one message per pair of ranks,
    recorded with the bytes the rank receives).  An entry is one range
    (a, b) or a tuple of ranges, held and returned concatenated in that
    order (a strided set of columns, such as dims [4r, 4r + 4) of every
    head).  ``want`` ranges may be empty or overlap between ranks;
    ``have`` ranges are disjoint between ranks.  Differentiable: the
    backward returns each piece's grad to its source, summed over the
    ranks that took it."""
    dim = dim % x.dim()
    have = tuple(_ranges(h) for h in have)
    want = tuple(_ranges(w) for w in want)
    if axis_size(axis, mesh) == 1:
        parts = [x.narrow(dim, _local(have[0], a), b - a)
                 for a, b in want[0] if b > a]
        if len(parts) == 1:
            return parts[0]
        shape = list(x.shape)
        shape[dim] = 0
        return torch.cat(parts, dim=dim) if parts else x.new_empty(shape)
    return _Regroup.apply(x, have, want, axis, mesh, dim)
