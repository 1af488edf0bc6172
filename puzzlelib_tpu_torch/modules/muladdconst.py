"""Affine constant transform ``a * x + b`` (counterpart of
``puzzlelib_tpu/modules/muladdconst.py``), in the input's type."""

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.ops import elementwise as ew
from puzzlelib_tpu_torch.modules.module import Module


class MulAddConst(Module):
    def __init__(self, a=1.0, b=0.0, inplace=False, name=None):
        super().__init__(name)
        self.registerBlueprint(locals())

        self.a, self.b = a, b

        self.inplace = inplace
        if inplace and Config.showWarnings:
            Config.getLogger().info("Warning: %s is using inplace flag", self)

    def _emit(self, src, value):
        return src.copy_(value) if self.inplace else value

    def updateData(self, data):
        self.data = self._emit(data, ew.linear(data, self.a, self.b))

    def updateGrad(self, grad):
        self.grad = self._emit(grad, ew.linear(grad, self.a, 0.0))

    def dataShapeFrom(self, shape):
        return shape

    def gradShapeFrom(self, shape):
        return shape

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
