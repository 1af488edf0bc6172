"""Tiling along one axis (counterpart of ``puzzlelib_tpu/modules/tile.py``):
the forward repeats the input ``times`` along ``axis``; the backward adds
the gradient's ``times`` pieces one after another, in order, as the
reference does."""

from puzzlelib_tpu_torch.modules.module import ModuleError, Module


class Tile(Module):
    def __init__(self, axis, times, name=None):
        super().__init__(name)

        self.axis = axis
        self.times = times

    def updateData(self, data):
        reps = [1] * data.dim()
        reps[self.axis] = self.times
        self.data = data.repeat(reps)

    def updateGrad(self, grad):
        pieces = grad.chunk(self.times, dim=self.axis)

        acc = pieces[0].clone()
        for piece in pieces[1:]:
            acc.add_(piece)

        self.grad = acc

    def checkDataShape(self, shape):
        if len(shape) < self.axis + 1:
            raise ModuleError("Not enough dimensions in data shape (%s given, %s required)" %
                              (len(shape), self.axis + 1))

    def dataShapeFrom(self, shape):
        return tuple(shape[:self.axis]) + (shape[self.axis] * self.times, ) + tuple(shape[self.axis + 1:])

    def checkGradShape(self, shape):
        if len(shape) < self.axis + 1:
            raise ModuleError("Not enough dimensions in grad shape (%s given, %s required)" %
                              (len(shape), self.axis + 1))

        if shape[self.axis] % self.times != 0:
            raise ModuleError("Dimension %s in grad shape must be divisible by %s" % (shape[self.axis], self.times))

    def gradShapeFrom(self, shape):
        return tuple(shape[:self.axis]) + (shape[self.axis] // self.times, ) + tuple(shape[self.axis + 1:])

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
