"""Softmax over the channel axis (counterpart of
``puzzlelib_tpu/modules/softmax.py``)."""

from puzzlelib_tpu_torch.backend.dnn import softmaxNd, softmaxNdBackward
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

    def updateGrad(self, grad):
        shape = grad.shape
        ndim = max(0, 4 - len(shape))

        grad = grad.reshape(tuple(shape) + (1, ) * ndim)
        data = self.data.reshape(tuple(shape) + (1, ) * ndim)

        self.grad = softmaxNdBackward(data, grad).reshape(shape)

    def dataShapeFrom(self, shape):
        return shape

    def gradShapeFrom(self, shape):
        return shape

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
