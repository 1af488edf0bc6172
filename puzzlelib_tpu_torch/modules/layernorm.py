"""Layer normalization over the last dimension (counterpart of
``puzzlelib_tpu/modules/layernorm.py``).

Mean, variance and rsqrt in f32, the f32 scale and shift applied in f32, and
the result cast back to the input's type.  ``calcMode`` leaves the scale and
shift in f32, as the reference does.  The backward comes with the training
slice.
"""

import numpy as np
import torch

from puzzlelib_tpu_torch.variable import Variable
from puzzlelib_tpu_torch.modules.module import ModuleError, Module, backwardNotPorted


def layerNorm(x, scale, bias, epsilon):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    norm = (x32 - mean) * torch.rsqrt(var + epsilon)
    return (norm * scale + bias).to(x.dtype)


class LayerNorm(Module):
    def __init__(self, size, epsilon=1e-5, name=None):
        super().__init__(name)

        self.size = size
        self.epsilon = epsilon

        self.setVar("scale", Variable(self.paramTensor(np.ones(size, np.float32), (size, ))))
        self.setVar("bias", Variable(self.paramTensor(np.zeros(size, np.float32), (size, ))))

    def updateData(self, data):
        self.data = layerNorm(data, self.scale, self.bias, self.epsilon)

    def updateGrad(self, grad):
        raise backwardNotPorted(self)

    def accGradParams(self, grad, scale=1.0, momentum=0.0):
        raise backwardNotPorted(self)

    def checkDataShape(self, shape):
        if shape[-1] != self.size:
            raise ModuleError("Expected last dim %d, got %d" % (self.size, shape[-1]))

    def dataShapeFrom(self, shape):
        return shape

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
