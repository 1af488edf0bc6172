"""Parametric ReLU (counterpart of ``puzzlelib_tpu/modules/prelu.py``):
learnable negative slopes, one a map or one shared (``sharedMaps``),
initialised to 0.25 (``backend.kernels.prelu``).  An inplace module writes
its output over its input, unless the input is a view of another tensor
(``Module.writeOver``), and refuses the backward, whose data gradient reads
the input.  Unlike the reference, it takes the types ``calcMode`` allows,
its slopes cast to the type as a Linear's weights are."""

import numpy as np

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.backend.kernels.prelu import prelu, preluBackwardData, preluBackwardParams
from puzzlelib_tpu_torch.variable import Variable
from puzzlelib_tpu_torch.modules.module import ModuleError, Module

INIT_SLOPE = 0.25


class PRelu(Module):
    def __init__(self, maps, inplace=False, sharedMaps=False, name=None):
        super().__init__(name)

        self.sharedMaps, self.inplace = sharedMaps, inplace

        if inplace and Config.showWarnings:
            Config.getLogger().info("Warning: %s is using inplace flag", self)

        nSlopes = 1 if sharedMaps else maps
        self.slopes = None
        self.setVar("slopes", Variable(self.paramTensor(np.full((nSlopes, ), INIT_SLOPE, dtype=np.float32),
                                                        (nSlopes, ))))

    def _forbidInplaceBackward(self):
        if self.inplace:
            raise ModuleError("%s: using inplace flag while calculating gradient is prohibited" % self)

    def updateData(self, data):
        self.data = self.writeOver(data, prelu(data, self.slopes, self.sharedMaps))

    def updateGrad(self, grad):
        self._forbidInplaceBackward()
        self.grad = preluBackwardData(grad, self.slopes, self.inData, self.sharedMaps)

    def accGradParams(self, grad, scale=1.0, momentum=0.0):
        self._forbidInplaceBackward()
        self.foldParamGrad("slopes", preluBackwardParams(self.inData, grad, self.sharedMaps), scale, momentum)

    def dataShapeFrom(self, shape):
        return shape

    gradShapeFrom = dataShapeFrom

    def checkDataShape(self, shape):
        if len(shape) < 2:
            raise ModuleError("Data tensor dimension must be at least 2")

        nSlopes = self.slopes.shape[0]
        if not self.sharedMaps and shape[1] != nSlopes:
            raise ModuleError("Data tensor has %s maps (expected %s)" % (shape[1], nSlopes))

    def checkGradShape(self, shape):
        if shape != tuple(self.inData.shape):
            raise ModuleError("Grad tensor has shape %s (expected %s)" % (shape, tuple(self.inData.shape)))

    def calcMode(self, T):
        self.castVarsTo(self.requireSupportedDtype(T))
