"""Softmax over the channel axis, forward (counterpart of
``puzzlelib_tpu/modules/softmax.py``)."""

from puzzlelib_tpu_torch.backend.dnn import softmaxNd
from puzzlelib_tpu_torch.modules.module import Module


class SoftMax(Module):
    def __init__(self, name=None):
        super().__init__(name)
        self.gradUsesOutData = True

    def updateData(self, data):
        shape = data.shape
        ndim = max(0, 4 - len(shape))

        data = data.reshape(tuple(shape) + (1, ) * ndim)
        self.data = softmaxNd(data).reshape(shape)

    def dataShapeFrom(self, shape):
        return shape

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
