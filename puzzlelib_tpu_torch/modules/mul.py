"""Elementwise product of a list of equal-shaped inputs (counterpart of
``puzzlelib_tpu/modules/mul.py``): the forward multiplies them left to
right; each input's gradient is the incoming gradient times the other
inputs, in the reference's order."""

from functools import reduce

from puzzlelib_tpu_torch.modules.module import ModuleError, Module


def _product(tensors):
    return reduce(lambda a, b: a * b, tensors)


class Mul(Module):
    def updateData(self, data):
        self.data = _product(data)

    def updateGrad(self, grad):
        xs = self.inData
        self.grad = [_product([grad] + xs[:i] + xs[i + 1:]) for i in range(len(xs))]

    def checkDataShape(self, shapes):
        for shape in shapes:
            if shape != shapes[0]:
                raise ModuleError("Shape %s is not equal to initial shape %s" % (shape, shapes[0]))

    def dataShapeFrom(self, shape):
        return shape

    def gradShapeFrom(self, shape):
        return [shape] * len(self.inData)

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
