"""Sharding rules: logical axes -> a per-dim spec on the mesh, and the
explicit layout that replaces GSPMD.

Mesh axes (``launch/mesh.py``):
  pod   — data-parallel across pods (multi-pod only)
  data  — data-parallel / FSDP / sequence-parallel axis within a pod
  model — the second axis (heads, d_ff, vocab, experts' ff)

The rules (``LOGICAL_RULES``, ``PARAM_RULES``, ``param_specs``) are the
JAX package's, verbatim.  A spec is a plain tuple with one entry per dim,
each ``None``, an axis name or a tuple of axis names (the counterpart of
a ``PartitionSpec``); a dim sharded over a tuple of axes is split in
row-major order over them, as a ``NamedSharding`` splits it.

There is no GSPMD here.  A tensor is either *global* (the same on every
rank) or a rank's *block* of a global tensor under a spec; ``shard_of``
takes the block, ``gather_leaf`` rebuilds the global tensor (its backward
reduce-scatters, so a block's grad comes out summed over the ranks that
shared the gather), and the collectives of ``distributed/collectives.py``
are written out where the JAX package's ``shard_map`` bodies call them.
``constrain`` is a GSPMD hint and returns its input.

Under an :class:`AbstractMesh` (the dry-run) a program runs as rank 0's
program on the ``meta`` device: ``coordinate`` is rank 0's and each
collective returns a ``meta`` tensor of its result's shape and is
recorded, not performed (``collectives.record_collectives``).
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

# Logical axis -> mesh axes (None = replicated).
LOGICAL_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": "data",        # sequence-parallel KV cache (long-context decode)
    "heads": "model",
    "kv_heads": "model",
    "embed": None,           # d_model replicated in TP...
    "embed_fsdp": ("pod", "data"),  # ...but FSDP-sharded for storage
    "act_seq": "model",      # Megatron-style sequence-sharded activations
    "mlp": "model",
    "vocab": "model",
    "expert": None,
    "stack": None,           # scan-stacked layer dim
}


class AbstractMesh:
    """A mesh's axis names and sizes with no process group behind it (the
    counterpart of ``jax.sharding.AbstractMesh``): enough for the sharding
    rules, block shapes and per-rank bytes, and for rank 0's program on
    ``meta`` tensors, whose collectives are recorded, not performed
    (another rank's with ``coordinate``, its index along each axis)."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 coordinate: Optional[Tuple[int, ...]] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} vs axes {axis_names}")
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(axis_names)
        # whose program runs on it: rank 0's unless a coordinate is given
        self.coordinate = tuple(coordinate) if coordinate is not None \
            else (0,) * len(self.shape)

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape}, {self.mesh_dim_names})"


def is_abstract(mesh) -> bool:
    return isinstance(mesh, AbstractMesh)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def axes_of(entry) -> Tuple[str, ...]:
    """A spec entry as a tuple of axis names (() for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass(frozen=True)
class ParallelContext:
    """Carried through model code; None mesh => single-device semantics.

    ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` over an
    initialized process group, or an :class:`AbstractMesh` where only the
    rules are wanted."""

    mesh: Optional[Any] = None
    fsdp: bool = True              # shard params/optimizer over data axis too
    # Flash-decoding: shard the KV-cache *sequence* dim over this axis and
    # merge per-shard partial softmaxes with one tiny psum.
    kv_seq_axis: Optional[str] = None
    quantized: bool = False        # weights stored as int4 tile-quant
    # Megatron-style sequence parallelism for the residual stream: the
    # transformer family's layer-boundary residual is each rank's block of
    # the sequence over "model" (``models.tensor_parallel``).
    shard_activations_seq: bool = False
    # tp=False turns the "model" axis into a second FSDP axis: params and
    # the batch shard over every axis.
    tp: bool = True

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names) if self.mesh is not None \
            else ()

    @property
    def shape(self) -> dict:
        return mesh_shape(self.mesh) if self.mesh is not None else {}

    def _filter(self, axes):
        """Drop mesh axes that do not exist (e.g. no 'pod' on single pod)."""
        if axes is None:
            return None
        if isinstance(axes, str):
            return axes if axes in self.axes else None
        got = tuple(a for a in axes if a in self.axes)
        return got if got else None

    def spec(self, *logical) -> tuple:
        parts = []
        for name in logical:
            if name is None:
                parts.append(None)
            elif name == "embed_fsdp" and not self.fsdp:
                parts.append(None)  # serving: keep d_model replicated
            elif name == "kv_seq" and self.kv_seq_axis is None:
                parts.append(None)
            elif name == "act_seq" and not self.shard_activations_seq:
                parts.append(None)
            elif not self.tp and name in ("heads", "kv_heads", "mlp",
                                          "vocab", "act_seq"):
                parts.append(None)  # fsdp-only layout: no tensor parallelism
            elif not self.tp and name in ("embed_fsdp", "batch"):
                # fsdp-only: params AND batch shard over every axis
                parts.append(self._filter(("pod", "data", "model")))
            else:
                parts.append(self._filter(LOGICAL_RULES[name]))
        return tuple(parts)

    def constrain(self, x, *logical):
        """The JAX package's ``with_sharding_constraint``, a hint to GSPMD
        about a global array's layout.  The port's layout is explicit (each
        function states which of its tensors are global and which are
        blocks), so there is nothing to hint: returns ``x``."""
        return x

    def batch_axes_for(self, batch_size: int):
        """Mesh axes to shard a batch dim over, dropping axes (pod first)
        until the batch divides — small decode batches fall back toward
        replication instead of failing divisibility."""
        axes = self._filter(("pod", "data"))
        while axes is not None:
            axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
            size = math.prod(self.shape[a] for a in axes_t)
            if batch_size % size == 0:
                return axes
            axes = axes_t[1:] if len(axes_t) > 1 else None
        return None

    @property
    def n_data(self) -> int:
        return self.shape.get("data", 1)

    @property
    def n_model(self) -> int:
        return self.shape.get("model", 1)

    def size(self, entry) -> int:
        """Ranks a spec entry splits over (1 for None)."""
        return math.prod(self.shape[a] for a in axes_of(entry))


# ---------------------------------------------------------------------------
# Parameter partition rules (path regex -> logical axes per dim).
#
# Param trees are nested dicts in the JAX package's layout; paths look like
# "layers/attn/wq/w", "layers/ffn/experts/gate", "embedding/table", ...
# Stacked (scanned) layer params have a leading "stack" dim.  The port keeps
# its layers as per-layer lists: ``stack_layers`` gives the JAX layout.
# ---------------------------------------------------------------------------

PARAM_RULES = [
    # embeddings / lm head: vocab-sharded (beyond-paper: distributed sampling)
    (r".*embedding/table$", ("vocab", "embed")),
    (r".*lm_head/table$", ("vocab", "embed")),
    (r".*patch_proj/w$", ("embed_fsdp", None)),
    # attention projections
    (r".*w[qkv]/w$", ("embed_fsdp", "heads")),
    (r".*wo/w$", ("heads", "embed_fsdp")),
    (r".*w[qkv]/b$", ("heads",)),
    # dense FFN
    (r".*(gate|up|fc1)/w$", ("embed_fsdp", "mlp")),
    (r".*(down|fc2)/w$", ("mlp", "embed_fsdp")),
    (r".*fc1/b$", ("mlp",)),
    (r".*fc2/b$", (None,)),
    # MoE
    (r".*router/w$", (None, None)),
    (r".*experts/(gate|up)$", ("expert", "embed_fsdp", "mlp")),
    (r".*experts/down$", ("expert", "mlp", "embed_fsdp")),
    # mamba2
    (r".*in_proj/w$", ("embed_fsdp", "mlp")),
    (r".*out_proj/w$", ("mlp", "embed_fsdp")),
    (r".*conv/w$", (None, "mlp")),
    (r".*conv/b$", ("mlp",)),
    (r".*(A_log|dt_bias|D)$", ("mlp",)),
    # norms / scalars
    (r".*(scale|bias)$", (None,)),
]


def logical_axes_for(path: str, ndim: int, stacked: bool) -> Tuple:
    base = None
    for pat, axes in PARAM_RULES:
        if re.match(pat, path):
            base = axes
            break
    if base is None:
        base = (None,) * (ndim - (1 if stacked else 0))
    if stacked:
        base = ("stack",) + tuple(base)
    # pad/trim to ndim
    base = tuple(base)[:ndim]
    base = base + (None,) * (ndim - len(base))
    return base


def _walk(tree, fn, path=""):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        raise TypeError(f"{path!r}: param_specs takes the JAX layout (nested "
                        f"dicts, stacked layers); stack the port's "
                        f"per-layer lists first (sharding.stack_layers)")
    return fn(path, tree)


def param_specs(params, par: ParallelContext, stacked_prefixes=("layers",)):
    """Spec tree matching ``params``, a tree in the JAX package's layout
    (nested dicts, stacked ``(L, ...)`` layer leaves; tensors on any
    device, ``meta`` included).  The JAX package's rules exactly, down to
    ``stacked_prefixes`` matching only paths that start with or contain
    ``layers``."""

    def _divisible(spec: tuple, shape) -> tuple:
        """Drop axis assignments that do not evenly divide the dim (e.g. a
        151655 vocab cannot 16-way shard)."""
        if par.mesh is None:
            return spec
        parts = []
        for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
            if entry is None:
                parts.append(None)
                continue
            parts.append(entry if dim % par.size(entry) == 0 else None)
        return tuple(parts)

    def one(ps, leaf):
        # Quantized leaves live under the original weight path
        # (".../wq/w/codes"): shard codes/scales like the weight itself,
        # extra (tile) dims replicated; codebooks replicated.
        qsuffix = None
        for suf in ("/codes", "/scales", "/codebook", "/meta"):
            if ps.endswith(suf):
                qsuffix = suf
                ps = ps[: -len(suf)]
                break
        if qsuffix in ("/codebook", "/meta"):
            return par.spec(*([None] * leaf.ndim))
        stacked = any(ps.startswith(pref) or f"/{pref}/" in ps
                      for pref in stacked_prefixes)
        axes = logical_axes_for(ps, leaf.ndim, stacked)
        return _divisible(par.spec(*axes), leaf.shape)

    return _walk(params, one)


def stack_layers(params) -> dict:
    """The port's tree in the JAX package's layout: each per-layer list
    stacked into ``(L, ...)`` leaves under the list's key (``torch.stack``;
    free on ``meta`` tensors), every other leaf as it is."""
    from repro_torch import tree as T

    out: dict = {}
    for path, parts, stacked in T.stacked_leaves(params):
        *keys, last = path.split("/")
        node = out
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = torch.stack(parts) if stacked else parts[0]
    return out


# ---------------------------------------------------------------------------
# Blocks of global tensors
# ---------------------------------------------------------------------------


def coordinate(par: ParallelContext) -> dict:
    """{axis: this rank's index along it}; under an :class:`AbstractMesh`
    its ``coordinate`` (rank 0's, all zeros, unless given)."""
    if is_abstract(par.mesh):
        return dict(zip(par.axes, par.mesh.coordinate))
    return dict(zip(par.axes, par.mesh.get_coordinate()))


def _index(entry, coord: dict, shape: dict) -> int:
    """Block index of a dim split over ``entry``'s axes, row-major."""
    idx = 0
    for a in axes_of(entry):
        idx = idx * shape[a] + coord[a]
    return idx


def local_shape(shape, spec, par: ParallelContext) -> tuple:
    """The block shape of a global ``shape`` under ``spec``."""
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        n = par.size(entry)
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"{n} ways over {entry}")
        out.append(dim // n)
    return tuple(out)


def shard_of(x: torch.Tensor, spec, par: ParallelContext, *,
             coord: Optional[dict] = None) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec`` (a
    view; ``coord`` overrides the rank's mesh coordinate).  Under
    autograd the block's grad lands in its place of ``x``'s."""
    if par.mesh is None:
        return x
    coord = coordinate(par) if coord is None else coord
    shape = par.shape
    for i, entry in enumerate(spec):
        n = par.size(entry)
        if n == 1:
            continue
        if x.shape[i] % n:
            raise ValueError(f"dim {i} of {tuple(x.shape)} does not split "
                             f"{n} ways over {entry}")
        b = x.shape[i] // n
        x = x.narrow(i, _index(entry, coord, shape) * b, b)
    return x


def gather_leaf(x: torch.Tensor, spec, par: ParallelContext, *,
                keep=()) -> torch.Tensor:
    """The global tensor of which ``x`` is this rank's block under
    ``spec``: one all-gather per sharded dim.  Differentiable: the
    backward reduce-scatters, so each rank's block grad is the sum over
    the ranks that gathered it of their grads for that block.

    ``keep``: mesh axes not to gather over; a dim split over any of them
    is left as the rank's block of it (the tensor-parallel layout keeps
    its weights on ``model``).  Never gathers over a kept axis."""
    if par.mesh is None:
        return x
    from repro_torch.distributed import collectives as C

    for i, entry in enumerate(spec):
        if keep:
            axes = axes_of(entry)
            entry = tuple(a for a in axes if a not in keep)
            if entry and len(entry) != len(axes):
                raise ValueError(f"dim {i} of {spec} is split over kept "
                                 f"and other axes together")
            entry = entry[0] if len(entry) == 1 else (entry or None)
            assert not set(axes_of(entry)) & set(keep), (spec, keep)
        if par.size(entry) > 1:
            x = C.all_gather(x, entry, par.mesh, dim=i, tiled=True)
    return x


def shard_tree(tree, specs, par: ParallelContext, *, coord=None):
    """Each leaf's block under its spec (specs congruent with ``tree``),
    cloned so the block owns its storage."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], par, coord=coord)
                for k, v in tree.items()}
    return shard_of(tree, specs, par, coord=coord).clone()


def gather_tree(tree, specs, par: ParallelContext, *, to=None):
    """The global tree of a tree of blocks, one leaf at a time (every rank
    takes part); ``to`` moves each gathered leaf (e.g. ``"cpu"``) before
    the next is gathered."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, specs[k], par, to=to)
                for k, v in tree.items()}
    with torch.no_grad():
        g = gather_leaf(tree, specs, par)
    return g if to is None else g.to(to)


def leaf_bytes(shape, dtype, spec, par: ParallelContext) -> int:
    """Bytes a rank stores of a leaf of global ``shape`` under ``spec``."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return math.prod(local_shape(shape, spec, par)) * itemsize


def tree_bytes(tree, specs, par: ParallelContext) -> int:
    """Bytes a rank stores of a JAX-layout tree under its specs."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v, specs[k], par) for k, v in tree.items())
    return leaf_bytes(tree.shape, tree.dtype, specs, par)
