"""Instance normalization over the spatial dims of 4d maps (counterpart of
``puzzlelib_tpu/modules/instancenorm2d.py``): batch norm of the (1, N * C,
H, W) view with the f32 scale and bias tiled over the batch
(``ops/norm.py``), the scale and bias gradients folded back to (C, )."""

import numpy as np

from puzzlelib_tpu_torch.backend import gpuarray
from puzzlelib_tpu_torch.backend.dnn import instanceNorm2d, instanceNorm2dBackward
from puzzlelib_tpu_torch.variable import Variable
from puzzlelib_tpu_torch.modules.module import ModuleError, Module


class InstanceNorm2D(Module):
    def __init__(self, numOfMaps, epsilon=1e-5, affine=True, name=None):
        super().__init__(name)

        self.numOfMaps = numOfMaps
        self.epsilon = epsilon
        self.affine = affine

        self.scale = self.bias = None
        affineShape = (1, numOfMaps, 1, 1)
        self.setVar("scale", Variable(gpuarray.to_gpu(np.ones(affineShape, dtype=np.float32))))
        self.setVar("bias", Variable(gpuarray.zeros(affineShape, dtype=np.float32)))

        self._saved = None       # (mean, invstd, tiled scale) from the last forward
        self._paramGrads = None  # (dscale, dbias) from the last backward

    def updateData(self, data):
        self.data, mean, invstd, extscale = instanceNorm2d(data, self.scale, self.bias, self.epsilon)
        self._saved = (mean, invstd, extscale)

    def updateGrad(self, grad):
        mean, invstd, extscale = self._saved
        result = instanceNorm2dBackward(grad, self.inData, extscale, mean, invstd, self.epsilon, self.affine)

        if self.affine:
            self.grad, dscale, dbias = result
            self._paramGrads = (dscale, dbias)
        else:
            self.grad = result

    def accGradParams(self, grad, scale=1.0, momentum=0.0):
        if self.affine:
            dscale, dbias = self._paramGrads
            self.foldParamGrad("scale", dscale, scale, momentum)
            self.foldParamGrad("bias", dbias, scale, momentum)

    def reset(self):
        super().reset()
        self._saved = self._paramGrads = None

    def dataShapeFrom(self, shape):
        return shape

    def gradShapeFrom(self, shape):
        return shape

    def checkDataShape(self, shape):
        if len(shape) != 4:
            raise ModuleError("Data must be 4d tensor")

    def checkGradShape(self, shape):
        if shape != tuple(self.data.shape):
            raise ModuleError("Inconsistency in grad shape - expected %s (%s given)" % (tuple(self.data.shape), shape))

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
