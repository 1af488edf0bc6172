"""Move of one axis to a new place, numpy's ``moveaxis`` (counterpart of
``puzzlelib_tpu/modules/moveaxis.py``); the backward is the inverse move.
Both return fresh contiguous tensors, as the reference's copies are, not
views (``backend.memory.moveaxis``)."""

import torch

from puzzlelib_tpu_torch.backend import memory as Memory
from puzzlelib_tpu_torch.modules.module import ModuleError, Module


def _movedShape(shape, src, dst):
    s = list(shape)
    s.insert(dst, s.pop(src))
    return tuple(s)


class MoveAxis(Module):
    def __init__(self, src, dst, name=None):
        super().__init__(name)

        if src == dst:
            raise ModuleError("Trivial axis move is treated as error")

        self.src, self.dst = src, dst

    def updateData(self, data):
        self.data = Memory.moveaxis(data, self.src, self.dst).clone(memory_format=torch.contiguous_format)

    def updateGrad(self, grad):
        self.grad = Memory.moveaxis(grad, self.dst, self.src).clone(memory_format=torch.contiguous_format)

    def _requireRank(self, shape, what):
        need = max(self.src, self.dst) + 1
        if len(shape) < need:
            raise ModuleError("%s dimension needs to be at least %d, (%s has %d)" %
                              (what, need, what.lower(), len(shape)))

    def checkDataShape(self, shape):
        self._requireRank(shape, "Data")

    def checkGradShape(self, shape):
        self._requireRank(shape, "Grad")

    def dataShapeFrom(self, shape):
        return _movedShape(shape, self.src, self.dst)

    def gradShapeFrom(self, shape):
        return _movedShape(shape, self.dst, self.src)

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
