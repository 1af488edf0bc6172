"""Elementwise hinge against +-1 targets (counterpart of
``puzzlelib_tpu/cost/hinge.py``): scores and int32 labels of one (batch,
cases) shape, error and descent gradient from ``ops.cost.hinge``; the
validation error divided by the batch, on the host in f64 for ``calcVal``,
as the reference's, and in f32 on the device for ``calcValDev``."""

import torch

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.ops import cost as costOps
from puzzlelib_tpu_torch.cost.cost import Cost, CostError, requireLabelRange


class Hinge(Cost):
    def verifyLabels(self, labels):
        requireLabelRange("Hinge", labels, -1, 1)

    def calcGrad(self, scores, labels):
        if Config.verifyData:
            self.verifyLabels(labels)

        err, grad = costOps.hinge(scores, labels)
        self.devErr.copy_(err)
        return grad

    def calcVal(self, scores, labels):
        if Config.verifyData:
            self.verifyLabels(labels)

        err, _ = costOps.hinge(scores, labels)
        return err.item() / scores.shape[0]

    def calcValDev(self, scores, labels):
        if Config.verifyData:
            self.verifyLabels(labels)

        err, _ = costOps.hinge(scores, labels)
        return err / scores.shape[0]

    def checkDataShape(self, scores, labels):
        self._shapeContract(scores, labels)

    def checkValDataShape(self, scores, labels):
        self._shapeContract(scores, labels)

    @staticmethod
    def _shapeContract(scores, labels):
        if scores.dim() != 2 or tuple(scores.shape) != tuple(labels.shape):
            raise CostError("Hinge takes scores and labels of one (batch, cases) shape, got %s and %s" %
                            (tuple(scores.shape), tuple(labels.shape)))

        if labels.dtype != torch.int32:
            raise CostError("Hinge takes int32 labels, got %s" % labels.dtype)
