"""Helpers over trees of tensors: nested dicts, lists and tuples with
tensor leaves (counterpart of ``deeperspeed_tpu/utils/tree.py``)."""

import torch


def tree_leaves(tree):
    """The tensor leaves of ``tree`` in a fixed order (dict insertion order)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_cast(tree, dtype):
    """Cast all floating-point leaves to ``dtype``; leave ints/bools alone."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def tree_zeros_like(tree, dtype=None):
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype or x.dtype), tree)


def tree_global_norm(tree):
    """L2 norm over all leaves: the square root of the fp32 sum of squares."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    total = None
    for x in leaves:
        v = x.reshape(-1).to(torch.float32)
        sq = torch.dot(v, v)
        total = sq if total is None else total + sq
    return torch.sqrt(total)
