"""Flatten (counterpart of ``puzzlelib_tpu/modules/flatten.py``).

``reshape`` keeps the logical NCHW order, so a channels-last input (what the
Winograd kernel returns) is copied into row-major order here."""

import numpy as np

from puzzlelib_tpu_torch.modules.module import Module


class Flatten(Module):
    def __init__(self, name=None):
        super().__init__(name)
        self.movesData = True
        self.movesGrad = True
        self.inshape = None

    def updateData(self, data):
        self.inshape = tuple(data.shape)
        self.data = data.reshape(data.shape[0], int(np.prod(data.shape[1:])))

    def updateGrad(self, grad):
        self.grad = grad.reshape(self.inshape)

    def dataShapeFrom(self, shape):
        return shape[0], int(np.prod(shape[1:]))

    def gradShapeFrom(self, shape):
        return (shape[0], ) + self.inshape[1:]

    def calcMode(self, T):
        self.calctype = self.requireSupportedDtype(T)
