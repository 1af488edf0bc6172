"""Swap of two axes (counterpart of ``puzzlelib_tpu/modules/swapaxes.py``):
the forward and the backward are views (``backend.memory.swapaxes``).  The
axes are kept in ascending order, as in the reference."""

from puzzlelib_tpu_torch.backend import memory as Memory
from puzzlelib_tpu_torch.modules.module import ModuleError, Module


class SwapAxes(Module):
    def __init__(self, axis1, axis2, name=None):
        super().__init__(name)
        self.axis1, self.axis2 = (axis2, axis1) if axis1 > axis2 else (axis1, axis2)

    def updateData(self, data):
        self.data = Memory.swapaxes(data, self.axis1, self.axis2)

    def updateGrad(self, grad):
        self.grad = Memory.swapaxes(grad, self.axis1, self.axis2)

    def checkDataShape(self, shape):
        if len(shape) - 1 < self.axis2:
            raise ModuleError("Data dimension needs to be at least %d, (data has %d)" % (self.axis2 + 1, len(shape)))

    def checkGradShape(self, shape):
        if len(shape) - 1 < self.axis2:
            raise ModuleError("Grad dimension needs to be at least %d, (grad has %d)" % (self.axis2 + 1, len(shape)))

    def dataShapeFrom(self, shape):
        return shape[:self.axis1] + (shape[self.axis2], ) + shape[self.axis1 + 1:self.axis2] + \
               (shape[self.axis1], ) + shape[self.axis2 + 1:]

    def gradShapeFrom(self, shape):
        return self.dataShapeFrom(shape)

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
