"""Binary cross-entropy over raw logits with {0, 1} int32 labels
(counterpart of ``puzzlelib_tpu/cost/bce.py``): the sigmoid is fused into
the cost (``ops.cost.bce``), so a net trains without its top ``sigmoid``.
The error is the sum over every cell divided by the per-sample size; the
validation error is the share of cells whose logit's sign misses the label,
counted on the device.  Under ``Config.verifyData`` the labels are checked to
lie in [0, 1] (one readback)."""

import numpy as np
import torch

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.ops import cost as costOps
from puzzlelib_tpu_torch.cost.cost import Cost, CostError, requireLabelRange


class BCE(Cost):
    def verifyLabels(self, labels):
        requireLabelRange("BCE", labels, 0, 1)

    def calcGrad(self, scores, labels):
        if Config.verifyData:
            self.verifyLabels(labels)

        err, grad = costOps.bce(scores, labels)
        self.devErr.copy_(err)
        return grad

    def calcValDev(self, scores, labels):
        if Config.verifyData:
            self.verifyLabels(labels)

        return costOps.signMisses(scores, labels) / scores.numel()

    def checkDataShape(self, scores, labels):
        self._shapeContract(scores, labels)

    def checkValDataShape(self, scores, labels):
        self._shapeContract(scores, labels)

    @staticmethod
    def _shapeContract(scores, labels):
        if labels.dtype != torch.int32:
            raise CostError("BCE takes int32 labels, got %s" % labels.dtype)

        if scores.dim() == 2 and scores.shape[1] == 1:
            if labels.dim() != 1:
                raise CostError("BCE takes labels (batch, ) for scores (batch, 1), got %s" % (tuple(labels.shape), ))

        elif np.prod(scores.shape[1:]) != np.prod(labels.shape[1:]):
            raise CostError("BCE takes as many labels a sample as scores, got scores %s and labels %s" %
                            (tuple(scores.shape), tuple(labels.shape)))
