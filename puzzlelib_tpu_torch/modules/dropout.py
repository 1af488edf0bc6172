"""Inverted dropout (counterpart of ``puzzlelib_tpu/modules/dropout.py``).

In train mode each cell keeps its value, divided by the keep share 1 - p,
where its uniform 32-bit draw lies below ``partition = int((1 - p) *
(2**32 - 1))``, as in the reference, and is zeroed elsewhere; the backward
applies the same mask and scale to the gradient.  In eval mode the module
is the identity.  The draws come from ``rng`` (``rng.globalRng`` by
default) as int64 values in [0, 2**32), torch having no uint32 draw;
``_drawRands`` is the one place that draws them.  ``slicing`` (a slice of
the flat view) drops out only the cells it selects.  With ``inplace`` the
output is written over the input and the gradient over the incoming one,
unless that tensor is a view of another.
"""

import numpy as np
import torch

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.backend.device import getDevice
from puzzlelib_tpu_torch.ops import elementwise as ew
from puzzlelib_tpu_torch.modules.module import Module


UINT32_RANGE = 2 ** 32


class Dropout(Module):
    def __init__(self, p=0.5, rng=None, slicing=None, inplace=False, name=None):
        super().__init__(name)

        from puzzlelib_tpu_torch.rng import globalRng

        self.p = p
        self.partition = None
        self.rng = globalRng if rng is None else rng
        self.rands = None
        self.slice = slicing

        self.inplace = inplace
        if inplace and Config.showWarnings:
            Config.getLogger().info("Warning: %s is using inplace flag", self)

    def _drawRands(self, size):
        rands = torch.empty((size, ), dtype=torch.int64, device=getDevice())
        self.rng.fillInteger(rands, high=UINT32_RANGE)
        return rands

    def _keep(self):
        """(partition, keep share): the reference's threshold of the draws
        and the scale's divisor."""
        p = 1.0 - self.p
        return int(p * np.iinfo(np.uint32).max), p

    def updateData(self, data):
        if not self.training:
            self.data = data
            return

        self.rands = self._drawRands(data.numel()).reshape(data.shape)
        self.partition, p = self._keep()
        self.data = self.writeOver(data, ew.dropout(data, self.rands, self.partition, p, slice=self.slice))

    def updateGrad(self, grad):
        if not self.training:
            self.grad = grad
            return

        out = ew.dropout(grad, self.rands, self.partition, 1.0 - self.p, slice=self.slice)
        self.grad = self.writeOver(grad, out)

    def dataShapeFrom(self, shape):
        return shape

    def gradShapeFrom(self, shape):
        return shape

    def reset(self):
        super().reset()
        self.rands = None

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
