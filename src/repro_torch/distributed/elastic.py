"""Elastic scaling: move live state between meshes.

Because checkpoints store *global* arrays (``checkpoint/checkpointer.py``)
and the layout is derived from the param tree and a ``ParallelContext``
(``distributed/sharding.py``), scaling up or down is: build the new
mesh, recompute the specs, ``remesh`` (live) or ``elastic_restore``
(from disk).  No resharding-aware file format is needed: the manifest is
mesh-agnostic by construction.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.distributed.sharding import (ParallelContext, param_specs,
                                              shard_of, shard_tree)


def remesh(tree, new_par: ParallelContext, *, stacked_prefixes=("layers",)):
    """This rank's blocks of a live global tree (JAX layout) under
    ``new_par``'s specs; without a mesh, the tree itself."""
    if new_par.mesh is None:
        return tree
    specs = param_specs(tree, new_par, stacked_prefixes=stacked_prefixes)
    return shard_tree(tree, specs, new_par)


def elastic_restore(checkpointer, abstract_tree, new_par: ParallelContext,
                    step: Optional[int] = None, *, device=None,
                    stacked_prefixes=("layers",)):
    """Restore a checkpoint written under any previous mesh onto
    ``new_par``: each rank reads the global arrays and keeps its block
    of ``param_specs(abstract_tree, new_par, stacked_prefixes=)``.
    ``abstract_tree``: the global tree in the JAX layout (``meta`` tensors
    will do); ``device`` as ``Checkpointer.restore``'s.  Returns (tree,
    step)."""
    if new_par.mesh is None:
        return checkpointer.restore(abstract_tree, step=step, device=device)
    flat: dict = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else str(k))
        else:
            flat[path] = node

    walk(param_specs(abstract_tree, new_par,
                     stacked_prefixes=stacked_prefixes), "")
    return checkpointer.restore(
        abstract_tree, step=step, device=device,
        take=lambda path, t: shard_of(t, flat[path], new_par).clone())
