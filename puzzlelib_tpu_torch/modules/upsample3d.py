"""Integer-factor 3-d upsampling, nearest or linear with the corners
aligned (counterpart of ``puzzlelib_tpu/modules/upsample3d.py``), as
``Upsample2D`` over three spatial axes."""

from puzzlelib_tpu_torch.backend.kernels import upsample as Upsample
from puzzlelib_tpu_torch.modules.module import ModuleError, Module
from puzzlelib_tpu_torch.modules.upsample2d import UpsampleMode


class Upsample3D(Module):
    def __init__(self, scale=2, mode="nearest", name=None):
        super().__init__(name)

        self.scale = scale
        self.mode = UpsampleMode(mode)

    def updateData(self, data):
        self.data = Upsample.upsample3d(data, self.scale, mode=self.mode.value)

    def updateGrad(self, grad):
        self.grad = Upsample.upsample3dBackward(grad, self.scale, mode=self.mode.value)

    def checkDataShape(self, shape):
        if len(shape) != 5:
            raise ModuleError("Data must be 5d tensor")

    def checkGradShape(self, shape):
        if len(shape) != 5:
            raise ModuleError("Grad must be 5d tensor")

        for dim in shape[2:]:
            if dim % self.scale != 0:
                raise ModuleError("Grad map size is not divisible by scale %s" % self.scale)

    def dataShapeFrom(self, shape):
        return tuple(shape[:2]) + tuple(self.scale * dim for dim in shape[2:])

    def gradShapeFrom(self, shape):
        return tuple(shape[:2]) + tuple(dim // self.scale for dim in shape[2:])

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
