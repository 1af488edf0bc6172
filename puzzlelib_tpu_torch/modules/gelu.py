"""Gelu, the tanh approximation (counterpart of
``puzzlelib_tpu/modules/gelu.py``).  The backward derives from the module's
input, as the reference's does; with ``inplace`` the output overwrites the
input and the input gradient the output gradient, also as in the reference
(so an inplace backward derives from the overwritten input)."""

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.ops import elementwise as ew
from puzzlelib_tpu_torch.modules.module import Module


class Gelu(Module):
    def __init__(self, inplace=False, name=None):
        super().__init__(name)
        self.registerBlueprint(locals())
        self.inplace = inplace

        if inplace and Config.showWarnings:
            Config.getLogger().info("Warning: %s is using inplace flag", self)

    def updateData(self, data):
        out = ew.gelu(data)
        self.data = data.copy_(out) if self.inplace else out

    def updateGrad(self, grad):
        inGrad = ew.geluDer(grad, self.inData)
        self.grad = grad.copy_(inGrad) if self.inplace else inGrad

    def dataShapeFrom(self, shape):
        return shape

    def gradShapeFrom(self, shape):
        return shape

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
