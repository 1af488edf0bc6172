"""Sum over one axis (counterpart of ``puzzlelib_tpu/modules/sum.py``),
accumulated in f32 and cast back to the input's type.  The weighted sum
(``useWeights=True``) and the backward come with the training slice."""

from puzzlelib_tpu_torch.ops import blas as _blas
from puzzlelib_tpu_torch.modules.module import ModuleError, Module, backwardNotPorted


class Sum(Module):
    def __init__(self, axis, useWeights=True, name=None):
        super().__init__(name)

        if useWeights:
            raise NotImplementedError("Sum(useWeights=True) is not ported yet; it comes with the transformer "
                                      "training slice")

        self.useWeights = useWeights
        self.axis = axis

    def updateData(self, data):
        self.data = _blas.matsum(data, self.axis, None, 1.0, 0.0)

    def updateGrad(self, grad):
        raise backwardNotPorted(self)

    def dataShapeFrom(self, shape):
        return shape[:self.axis] + shape[self.axis + 1:]

    def checkDataShape(self, shape):
        if self.axis > len(shape) - 1:
            raise ModuleError("Not enough dims in data (%d were given, need at least %d)" %
                              (len(shape), self.axis + 1))

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
