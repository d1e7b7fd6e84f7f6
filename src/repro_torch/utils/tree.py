"""Nested dicts of tensors as the JAX package's pytrees, in JAX's order.

``jax.tree_util`` flattens a dict in sorted key order and treats None as
an empty subtree.  The port's parameter, gradient and optimizer trees
are nested dicts laid out as the reference's, and these helpers walk
them in that same order, so a sum over leaves (the global norm) adds in
the reference's order and a checkpoint names each leaf by the
reference's key path.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

import numpy as np
import torch

__all__ = ["tree_leaves", "tree_paths", "tree_map", "tree_unflatten", "tree_from_numpy"]


def tree_paths(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """``(path, leaf)`` in JAX's order; a path joins the keys with ``/``
    (the reference checkpointer's leaf names)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_paths(tree[key], f"{prefix}/{key}" if prefix else str(key))
    else:
        yield prefix, tree


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree``; each of ``rest`` is walked up to
    ``tree``'s structure, so its node at a leaf position may be a subtree
    (as ``treedef.flatten_up_to`` gives the reference's optimizers)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_unflatten(structure: Any, leaves: list) -> Any:
    """A tree of ``structure``'s shape holding ``leaves`` (in JAX's order).
    (A recursive closure here would be a reference cycle holding the
    leaves' iterator: the leaves, a step's gradients, would outlive the
    call until Python's cycle collector ran.)"""
    return _build(structure, iter(leaves))


def _build(node: Any, it) -> Any:
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    return next(it)


def tree_from_numpy(tree: Any, device="cuda") -> Any:
    """A tree of the JAX package's arrays, given as numpy arrays (bf16 as
    the ``ml_dtypes`` type JAX gives), as tensors on ``device``, each leaf
    keeping its type: converted through f32, which holds bfloat16, the
    int32 step and every smaller integer exactly."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    dt = getattr(torch, str(np.asarray(tree).dtype))
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device=device, dtype=dt)
