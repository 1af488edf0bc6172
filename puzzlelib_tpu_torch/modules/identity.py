"""The identity (counterpart of ``puzzlelib_tpu/modules/identity.py``): the
data and the gradient pass through as they are, the residual block's
shortcut where the maps keep their shape."""

from puzzlelib_tpu_torch.backend import gpuarray
from puzzlelib_tpu_torch.modules.module import Module


class Identity(Module):
    def __init__(self, name=None):
        super().__init__(name)
        self.movesData = True
        self.movesGrad = True

    def updateData(self, data):
        self.data = data

    def updateGrad(self, grad):
        self.grad = grad

    def dataShapeFrom(self, shape):
        return shape

    def gradShapeFrom(self, shape):
        return shape

    def calcMode(self, T):
        self.calctype = gpuarray.toTorchDtype(T)
