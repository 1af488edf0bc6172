"""Smooth L1 (Huber at 1) regression cost (counterpart of
``puzzlelib_tpu/cost/smoothl1.py``): the error normalised per sample, the
gradient by the whole count of cells, the validation error by the whole
count (``ops.cost.smoothL1``)."""

import numpy as np

from puzzlelib_tpu_torch.ops import cost as costOps
from puzzlelib_tpu_torch.cost.cost import Cost, requireSampleShape


class SmoothL1(Cost):
    def calcGrad(self, pred, target):
        perSample = 1.0 / np.prod(target.shape[1:])
        perElem = 1.0 / np.prod(target.shape)

        err, grad = costOps.smoothL1(pred, target, perSample, perElem)
        self.devErr.copy_(err)
        return grad

    def calcValDev(self, pred, target):
        perElem = 1.0 / np.prod(target.shape)

        err, _ = costOps.smoothL1(pred, target, perElem, perElem)
        return err

    def checkDataShape(self, pred, target):
        requireSampleShape("SmoothL1", pred, target)

    def checkValDataShape(self, pred, target):
        requireSampleShape("SmoothL1", pred, target)
