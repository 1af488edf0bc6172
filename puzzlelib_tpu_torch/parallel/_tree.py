"""Trees of tensors (dicts, lists and tuples, as the JAX package's pytrees
of parameters), and host arrays as tensors: the helpers that the
model-parallel functions and ``SwitchMoE`` share."""

import numpy as np
import torch

from puzzlelib_tpu_torch.backend import gpuarray


def treeMap(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {key: treeMap(fn, tree[key], *(other[key] for other in rest)) for key in tree}

    if isinstance(tree, (list, tuple)):
        return type(tree)(treeMap(fn, *items) for items in zip(tree, *rest))

    return fn(tree, *rest)


def treeLeaves(tree):
    if isinstance(tree, dict):
        return [leaf for key in tree for leaf in treeLeaves(tree[key])]

    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in treeLeaves(item)]

    return [tree]


def unflatten(tree, leaves):
    """``tree``'s structure over ``leaves`` (in ``treeLeaves`` order)."""
    it = iter(leaves)
    return treeMap(lambda _: next(it), tree)


def stackTrees(trees):
    """Parameter trees stacked along a new leading axis: one tensor for each
    leaf position."""
    return treeMap(lambda *leaves: torch.stack(leaves), trees[0], *trees[1:])


def asTensor(x):
    """A tensor as it is; a host array on the configured device."""
    return x if isinstance(x, torch.Tensor) else gpuarray.to_gpu(np.asarray(x))
