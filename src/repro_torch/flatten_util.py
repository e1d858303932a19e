"""The flat-D bijection of ``jax.flatten_util.ravel_pytree`` for dict trees.

Gradients, ŷ and the model update are flat vectors in the order
``ravel_pytree`` gives the JAX package's dict pytrees: keys sorted at every
level, each leaf row-major in its JAX layout (logreg ``w`` is (784, 10), conv
kernels are HWIO). Keeping that order is what lets a flat vector of the port
be compared with one of the reference.
"""
from __future__ import annotations

from typing import Callable

import torch


def tree_leaves(tree) -> list[torch.Tensor]:
    """The leaves of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves):
    """A dict shaped as ``tree`` (its keys in its own order) whose leaves are
    ``leaves`` taken in sorted-key order, the order of :func:`tree_leaves`."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        return next(it)

    return build(tree)


def tree_map(fn: Callable, tree):
    """``fn`` applied to every leaf of a nested dict (structure kept)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def ravel_pytree(tree) -> tuple[torch.Tensor, Callable]:
    """``tree -> (flat (D,), unravel)`` with ``unravel(flat)`` rebuilding it."""
    leaves = tree_leaves(tree)
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])
    shapes = [leaf.shape for leaf in leaves]

    def unravel(vec: torch.Tensor):
        it = iter(torch.split(vec, [s.numel() for s in shapes]))

        def build(node):
            if isinstance(node, dict):
                return {k: build(node[k]) for k in sorted(node)}
            chunk = next(it)
            return chunk.reshape(node.shape)

        return build(tree)

    return flat, unravel


def ravel_batched(tree) -> torch.Tensor:
    """Leaves with a shared leading axis (N, ...) -> (N, D) in ravel order."""
    leaves = tree_leaves(tree)
    n = leaves[0].shape[0]
    return torch.cat([leaf.reshape(n, -1) for leaf in leaves], dim=1)
