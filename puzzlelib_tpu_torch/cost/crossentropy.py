"""Softmax cross-entropy on raw scores (counterpart of
``puzzlelib_tpu/cost/crossentropy.py``), without per-class weights and
validation yet."""

import torch

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.ops import cost as costOps
from puzzlelib_tpu_torch.cost.cost import Cost, CostError, requireLabelRange


class CrossEntropy(Cost):
    def __init__(self, maxlabels=None):
        super().__init__()
        self.maxlabels = maxlabels

    def calcGrad(self, scores, labels):
        if Config.verifyData:
            requireLabelRange("Cross entropy", labels, 0, scores.shape[1] - 1)

        err, grad = costOps.crossEntropy(scores, labels)
        self.devErr.copy_(err)
        return grad

    def checkDataShape(self, scores, labels):
        if labels.dtype != torch.int32:
            raise CostError("Cross entropy takes int32 labels, got %s" % labels.dtype)

        if scores.dim() != labels.dim() + 1 or tuple(scores.shape[2:]) != tuple(labels.shape[1:]):
            raise CostError("Cross entropy takes scores (batch, classes, *spatial) and labels (batch, *spatial), "
                            "got %s and %s" % (tuple(scores.shape), tuple(labels.shape)))

        if self.maxlabels and scores.shape[1] != self.maxlabels:
            raise CostError("Cross entropy expected %d classes, got %d" % (self.maxlabels, scores.shape[1]))
