"""Parameter trees: nested dicts (and the port's per-layer lists) of
tensors, flattened in the JAX package's order.

``jax.tree_util`` flattens dicts by sorted key at every level, and the
JAX package keeps a family's layers as stacked ``(L, ...)`` leaves under
one key, where the port keeps a list of per-layer dicts.  ``flatten``
walks sorted keys and, at a per-layer list, each of its leaf paths once
(``stack_layers=True``), so the i-th leaf here is the JAX tree's i-th
leaf: what the checkpoint format and the bridge need.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable, List, Tuple


def flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, spec): the leaves in sorted-key order, lists in order;
    ``unflatten(spec, leaves)`` rebuilds the tree."""
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [walk(v) for v in node]
        leaves.append(node)
        return None

    return leaves, walk(tree)


def unflatten(spec, leaves: List[Any]):
    it = iter(leaves)

    def walk(s):
        if isinstance(s, dict):
            return {k: walk(v) for k, v in s.items()}
        if isinstance(s, list):
            return [walk(v) for v in s]
        return next(it)

    return walk(spec)


def map_with_path(fn: Callable, tree, *rest):
    """``fn(path, leaf, *rest_leaves)`` over congruent trees; ``path`` is
    the tuple of dict keys and list indices to the leaf."""

    def walk(path, node, *others):
        if isinstance(node, dict):
            return {k: walk(path + (k,), node[k], *(o[k] for o in others))
                    for k in node}
        if isinstance(node, list):
            return [walk(path + (i,), v, *(o[i] for o in others))
                    for i, v in enumerate(node)]
        return fn(path, node, *others)

    return walk((), tree, *rest)


def stacked_leaves(tree) -> List[Tuple[str, List[Any], bool]]:
    """The JAX package's flatten order of ``tree``: (path, parts, stacked)
    per JAX leaf, ``parts`` the port's leaves that form it: one per layer
    under a per-layer list (``stacked``: along a new leading axis), else
    the one leaf."""
    out: List[Tuple[str, List[Any], bool]] = []

    def walk(path, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{path}/{k}" if path else str(k), node[k])
        elif isinstance(node, list):
            per_layer = [flatten(v)[0] for v in node]
            for j, (sub, _) in enumerate(_paths(node[0])):
                out.append((f"{path}/{sub}" if sub else path,
                            [leaves[j] for leaves in per_layer], True))
        else:
            out.append((path, [node], False))

    walk("", tree)
    return out


def _paths(node, path: str = ""):
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _paths(node[k], f"{path}/{k}" if path else str(k))
    else:
        yield path, node


def digest(tree) -> str:
    """The sha256 of a tree of tensors: each leaf's bytes, in ``flatten``
    order, copied to the host one leaf at a time."""
    import torch

    h = hashlib.sha256()
    for leaf in flatten(tree)[0]:
        raw = leaf.detach().contiguous().reshape(-1).view(torch.uint8)
        h.update(raw.cpu().numpy().tobytes())
    return h.hexdigest()
