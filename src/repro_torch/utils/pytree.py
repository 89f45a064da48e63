"""Helpers over parameter trees: nested ``dict``s of tensors.

Leaves are visited in the order ``jax.tree_util`` flattens a dict — keys
sorted at every level — so a leaf list (and the flat row built from it)
means the same thing in the port and in the JAX package.  A placed leaf
(``utils.placed.Placed``, a tensor stored as blocks on a grid's slots) is
one leaf; ``tree_map`` maps it block by block where every tree's leaf at
that place is placed alike.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.utils.placed import Placed

Tree = Dict[str, Any]


def tree_leaves_with_path(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``[(path, leaf)]`` in sorted-key order, paths ``/``-joined."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out: List[Tuple[str, torch.Tensor]] = []
    for key in sorted(tree):
        out.extend(tree_leaves_with_path(tree[key], f"{prefix}/{key}" if prefix else str(key)))
    return out


def tree_leaves(tree) -> List[torch.Tensor]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def is_placed(tree) -> bool:
    """Whether a parameter tree is placed in blocks on a grid of several
    slots (``utils.placed.Placed`` leaves): the partitioned steps' input."""
    return any(isinstance(x, Placed) for x in tree_leaves(tree))


def tree_map_with_name(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """Map ``fn(name, leaf)`` over a tree, ``name`` the ``/``-joined path
    (``repro.utils.pytree.tree_map_with_name``'s names for dict trees)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_name(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of the same structure.  Where the
    leaf of every tree is a ``Placed`` leaf of one layout, ``fn`` runs once
    on each stored block (``Placed.map``); any other leaves are passed as
    they are."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, Placed) and all(isinstance(r, Placed) and r.layout == tree.layout
                                        for r in rest):
        return tree.map(fn, *rest)
    return fn(tree, *rest)


def tree_from_paths(items) -> Tree:
    """``[(path, leaf)]`` -> nested dict (the inverse of
    ``tree_leaves_with_path``)."""
    out: Tree = {}
    for path, leaf in items:
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


def tree_unflatten(like, leaves) -> Tree:
    """A tree shaped like ``like`` (empty subtrees kept) whose leaves, in
    ``tree_leaves`` order, are ``leaves``."""
    return _unflatten(like, iter(leaves))


def _unflatten(node, it):
    # a module-level helper, not a closure over ``it``: a nested function that
    # calls itself is a reference cycle that would hold ``leaves`` (a step's
    # gradients) until the garbage collector runs
    if isinstance(node, dict):
        return {k: _unflatten(node[k], it) for k in sorted(node)}
    return next(it)


def tree_sub(a, b):
    return tree_map(torch.subtract, a, b)


def tree_sq_norm(tree) -> torch.Tensor:
    """Σ over leaves of Σ x² in float32 (a 0-d tensor)."""
    return sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))


def tree_isfinite(tree) -> bool:
    """Every floating leaf is finite everywhere."""
    return all(bool(torch.isfinite(x).all()) for x in tree_leaves(tree)
               if x.is_floating_point())


def tree_device(tree) -> torch.device:
    """The device of a tree's first leaf (trees never span devices)."""
    return tree_leaves(tree)[0].device
