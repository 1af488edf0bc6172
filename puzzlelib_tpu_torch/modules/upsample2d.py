"""Integer-factor 2-d upsampling, nearest or linear with the corners
aligned (counterpart of ``puzzlelib_tpu/modules/upsample2d.py``; the work
is ``ops.upsample``'s).  Unlike the reference, it takes the types
``calcMode`` allows; linear interpolation and both backwards run in f32 and
round once."""

from enum import Enum

from puzzlelib_tpu_torch.backend.kernels import upsample as Upsample
from puzzlelib_tpu_torch.modules.module import ModuleError, Module


class UpsampleMode(str, Enum):
    nearest = "nearest"
    linear = "linear"


class Upsample2D(Module):
    def __init__(self, scale=2, mode="nearest", name=None):
        super().__init__(name)
        self.registerBlueprint(locals())

        self.scale = scale
        self.mode = UpsampleMode(mode)

    def updateData(self, data):
        self.data = Upsample.upsample2d(data, self.scale, mode=self.mode.value)

    def updateGrad(self, grad):
        self.grad = Upsample.upsample2dBackward(grad, self.scale, mode=self.mode.value)

    def dataShapeFrom(self, shape):
        n, c, h, w = shape
        return n, c, h * self.scale, w * self.scale

    def gradShapeFrom(self, shape):
        n, c, h, w = shape
        return n, c, h // self.scale, w // self.scale

    def checkDataShape(self, shape):
        if len(shape) != 4:
            raise ModuleError("Data must be 4d tensor")

    def checkGradShape(self, shape):
        if len(shape) != 4:
            raise ModuleError("Grad must be 4d tensor")

        if any(extent % self.scale for extent in shape[2:]):
            raise ModuleError("Grad map size is not divisible by scale %s" % self.scale)

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
