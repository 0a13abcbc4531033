"""Nested dicts of tensors: one helper shared by the checkpoint, export and
serving modules."""

import torch


def map_tensors(tree, fn, memo=None):
    """`tree` with fn applied to each tensor; tensors that view the same
    memory (the backbone's alias keys) map to one result."""
    memo = {} if memo is None else memo
    if torch.is_tensor(tree):
        key = (tree.device, tree.data_ptr(), tree.dtype, tuple(tree.shape),
               tree.stride())
        if key not in memo:
            memo[key] = fn(tree)
        return memo[key]
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn, memo) for k, v in tree.items()}
    return tree
