"""Top-k pooling along one axis (counterpart of
``puzzlelib_tpu/modules/kmaxpool.py``): the k largest values of each line,
in ascending order of value, and the backward's scatter of the gradient to
the cells they came from.

The k come from a stable descending sort: among equal values the lower
index first, as ``lax.top_k`` orders them (``torch.topk`` promises no order
for ties on the card, and relu outputs tie at 0 all the time); then the k
are reversed, as the reference reverses them.  A line's k indices are
distinct, so the backward's scatter writes each cell once and repeats bit
for bit.  Unlike the reference, it takes the types ``calcMode`` allows."""

import torch

from puzzlelib_tpu_torch.modules.module import ModuleError, Module


def kmaxForward(x, topk, axis):
    """(values, indices) of the top ``topk`` of each line along ``axis``,
    ascending by value."""
    moved = x.movedim(axis, -1)
    idx = torch.sort(moved, dim=-1, descending=True, stable=True).indices[..., :topk].flip(-1)
    return torch.gather(moved, -1, idx).movedim(-1, axis), idx.movedim(-1, axis)


def kmaxBackward(grad, idx, axis, axissize):
    moved, movedIdx = grad.movedim(axis, -1), idx.movedim(axis, -1)
    out = grad.new_zeros(moved.shape[:-1] + (axissize, ))
    return out.scatter_(-1, movedIdx, moved).movedim(-1, axis)


class KMaxPool(Module):
    def __init__(self, topk, axis, name=None):
        super().__init__(name)
        self.registerBlueprint(locals())

        self.topk = topk
        self.axis = axis
        self.indices = None

    def updateData(self, data):
        self.data, self.indices = kmaxForward(data, self.topk, self.axis)

    def updateGrad(self, grad):
        self.grad = kmaxBackward(grad, self.indices, self.axis, self.inData.shape[self.axis])

    def checkDataShape(self, shape):
        if self.axis >= len(shape):
            raise ModuleError("Data dimension needs to be at least %d, (data has %d)" % (self.axis + 1, len(shape)))

        if shape[self.axis] < self.topk:
            raise ModuleError("Data topk axis is too small (got %d, expected at least %d)" %
                              (shape[self.axis], self.topk))

    def checkGradShape(self, shape):
        if self.axis >= len(shape):
            raise ModuleError("Grad dimension needs to be at least %d, (grad has %d)" % (self.axis + 1, len(shape)))

        if shape[self.axis] != self.topk:
            raise ModuleError("Grad topk axis is wrong (got %d, expected exactly %d)" % (shape[self.axis], self.topk))

    def dataShapeFrom(self, shape):
        return tuple(shape[:self.axis]) + (self.topk, ) + tuple(shape[self.axis + 1:])

    def gradShapeFrom(self, shape):
        return tuple(shape[:self.axis]) + (self.inData.shape[self.axis], ) + tuple(shape[self.axis + 1:])

    def reset(self):
        super().reset()
        self.indices = None

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
