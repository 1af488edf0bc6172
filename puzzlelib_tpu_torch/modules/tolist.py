"""Flattening of a nested list of tensors (counterpart of
``puzzlelib_tpu/modules/tolist.py``): the forward gives the leaves in
depth-first order, the backward nests the flat gradient list as the input
was nested (Inception-v3's ``expandBlock``).

The module only moves tensors, so it takes every supported type.  The
reference's keeps the base ``Module.calcMode``, which refuses all but f32,
so its Inception-v3 cannot run in bf16; the port's can."""

import torch

from puzzlelib_tpu_torch.modules.module import ModuleError, Module


def _leaves(tree, isLeaf):
    """Depth-first leaf iterator over a nested list structure."""
    if isLeaf(tree):
        yield tree
    else:
        for branch in tree:
            yield from _leaves(branch, isLeaf)


def _renest(template, flat, isLeaf):
    """Rebuild ``template``'s nesting from the flat sequence ``flat``."""
    cursor = iter(flat)

    def build(node):
        if isLeaf(node):
            return next(cursor)

        return [build(branch) for branch in node]

    return build(template)


def _isTensor(obj):
    return isinstance(obj, torch.Tensor)


class ToList(Module):
    def __init__(self, name=None):
        super().__init__(name)
        self.movesData = True
        self.movesGrad = True

    def updateData(self, data):
        self.data = list(_leaves(data, _isTensor))

    def updateGrad(self, grad):
        self.grad = _renest(self.inData, grad, _isTensor)

    def dataShapeFrom(self, shapes):
        # a leaf here is a shape tuple, not a tensor
        return list(_leaves(shapes, lambda node: isinstance(node, tuple)))

    def gradShapeFrom(self, shapes):
        return _renest(self.inData, shapes, _isTensor)

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)

    def checkGradShape(self, shapes):
        for i, leaf in enumerate(_leaves(self.inData, _isTensor)):
            if tuple(leaf.shape) != shapes[i]:
                raise ModuleError("Inconsistency in data and corresponding grad shapes at index %s "
                                  "(expected %s, given %s)" % (i, tuple(leaf.shape), shapes[i]))
