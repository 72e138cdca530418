"""Nested parameter trees (dicts, lists and tuples of tensors): the few
``jax.tree_util`` operations the port needs."""
from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same-structured ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree):
    """The tensors of ``tree``, in order."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree
