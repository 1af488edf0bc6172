"""General axes permutation (counterpart of
``puzzlelib_tpu/modules/transpose.py``); the backward applies the inverse
permutation.  Both return fresh contiguous tensors, as the reference's
copies are, not views (``backend.memory.transpose``)."""

import numpy as np
import torch

from puzzlelib_tpu_torch.backend import memory as Memory
from puzzlelib_tpu_torch.modules.module import ModuleError, Module


class Transpose(Module):
    def __init__(self, axes=None, name=None):
        super().__init__(name)
        self.registerBlueprint(locals())

        self.axes = axes
        self.invaxes = None if axes is None else [int(i) for i in np.argsort(axes)]

    def updateData(self, data):
        self.data = Memory.transpose(data, self.axes).clone(memory_format=torch.contiguous_format)

    def updateGrad(self, grad):
        self.grad = Memory.transpose(grad, self.invaxes).clone(memory_format=torch.contiguous_format)

    def _requireRank(self, shape, what):
        if self.axes is not None and len(shape) != len(self.axes):
            raise ModuleError("%s dimension needs to be %d, (%s has %d)" %
                              (what, len(self.axes), what.lower(), len(shape)))

    def checkDataShape(self, shape):
        self._requireRank(shape, "Data")

    def checkGradShape(self, shape):
        self._requireRank(shape, "Grad")

    def dataShapeFrom(self, shape):
        return tuple(shape[axis] for axis in self.axes)

    def gradShapeFrom(self, shape):
        return tuple(shape[axis] for axis in self.invaxes)

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
