"""Layer normalization over the last dimension (counterpart of
``puzzlelib_tpu/modules/layernorm.py``).

Mean, variance and rsqrt in f32, the f32 scale and shift applied in f32, and
the result cast back to the input's type.  ``calcMode`` leaves the scale and
shift in f32, as the reference does, so in a bf16 net their gradients land in
the optimizer's f32 flat buffer.  The backward is written out in f32 (the
reference takes the VJP of its forward): dx in the input's type, dscale and
dbias in f32, computed once for ``updateGrad`` and ``accGradParams``.
"""

import numpy as np
import torch

from puzzlelib_tpu_torch.variable import Variable
from puzzlelib_tpu_torch.modules.module import ModuleError, Module


def layerNorm(x, scale, bias, epsilon):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    norm = (x32 - mean) * torch.rsqrt(var + epsilon)
    return (norm * scale + bias).to(x.dtype)


def layerNormBackward(x, scale, grad, epsilon):
    """(dx, dscale, dbias) of ``layerNorm`` for the output gradient ``grad``:
    with xhat = (x - mean) * rstd and g = grad * scale,
    dx = rstd * (g - mean(g) - xhat * mean(g * xhat)) over the last dim, and
    the parameter gradients summed over every other dim."""
    x32, g32 = x.float(), grad.float()
    mean = x32.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(((x32 - mean) ** 2).mean(dim=-1, keepdim=True) + epsilon)
    xhat = (x32 - mean) * rstd

    g = g32 * scale
    dx = rstd * (g - g.mean(dim=-1, keepdim=True) - xhat * (g * xhat).mean(dim=-1, keepdim=True))

    lead = tuple(range(x.dim() - 1))
    return dx.to(x.dtype), (g32 * xhat).sum(dim=lead), g32.sum(dim=lead)


class LayerNorm(Module):
    def __init__(self, size, epsilon=1e-5, name=None):
        super().__init__(name)
        self.registerBlueprint(locals())

        self.size = size
        self.epsilon = epsilon
        self._bwd = None

        self.setVar("scale", Variable(self.paramTensor(np.ones(size, np.float32), (size, ))))
        self.setVar("bias", Variable(self.paramTensor(np.zeros(size, np.float32), (size, ))))

    def updateData(self, data):
        self.data = layerNorm(data, self.scale, self.bias, self.epsilon)
        self._bwd = None

    def _backward(self, grad):
        """``layerNormBackward`` of the last forward, shared by
        ``updateGrad`` and ``accGradParams`` for one gradient (held strongly,
        so its identity cannot be recycled)."""
        if self._bwd is None or self._bwd[0] is not grad:
            self._bwd = (grad, layerNormBackward(self.inData, self.scale, grad, self.epsilon))

        return self._bwd[1]

    def updateGrad(self, grad):
        self.grad = self._backward(grad)[0]

    def accGradParams(self, grad, scale=1.0, momentum=0.0):
        _, dScale, dBias = self._backward(grad)

        self.foldParamGrad("scale", dScale, scale, momentum)
        self.foldParamGrad("bias", dBias, scale, momentum)

    def checkDataShape(self, shape):
        if shape[-1] != self.size:
            raise ModuleError("Expected last dim %d, got %d" % (self.size, shape[-1]))

    def checkGradShape(self, shape):
        self.checkDataShape(shape)

    def dataShapeFrom(self, shape):
        return shape

    def gradShapeFrom(self, shape):
        return shape

    def reset(self):
        super().reset()
        self._bwd = None

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
