"""Softmax cross-entropy on raw scores (counterpart of
``puzzlelib_tpu/cost/crossentropy.py``), with optional per-class
``weights`` and the validation error: the share of argmax predictions
(``mostProb``) that miss their labels."""

import numpy as np
import torch

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.backend import gpuarray
from puzzlelib_tpu_torch.ops import cost as costOps
from puzzlelib_tpu_torch.cost.cost import Cost, CostError, requireLabelRange


class CrossEntropy(Cost):
    def __init__(self, maxlabels=None, weights=None):
        super().__init__()

        self.maxlabels = maxlabels
        self.mostProb = None
        self.weights = gpuarray.to_gpu(weights) if isinstance(weights, np.ndarray) else weights

    def reset(self):
        super().reset()
        self.mostProb = None

    def verifyLabels(self, scores, labels):
        requireLabelRange("Cross entropy", labels, 0, scores.shape[1] - 1)

    def calcGrad(self, scores, labels):
        if Config.verifyData:
            self.verifyLabels(scores, labels)

        err, grad = costOps.crossEntropy(scores, labels, self.weights)
        self.devErr.copy_(err)
        return grad

    def calcValDev(self, scores, labels):
        if Config.verifyData:
            self.verifyLabels(scores, labels)

        # argmax over the class axis lines the predictions up with the labels
        # for any number of trailing spatial dims
        self.mostProb = torch.argmax(scores, dim=1).to(torch.int32)
        return costOps.accuracy(self.mostProb, labels) / labels.numel()

    def checkDataShape(self, scores, labels):
        self._shapeContract(scores, labels)

        if self.weights is not None and tuple(self.weights.shape) != (scores.shape[1], ):
            raise CostError("Cross entropy weights of shape %s for %d classes" %
                            (tuple(self.weights.shape), scores.shape[1]))

    def checkValDataShape(self, scores, labels):
        self._shapeContract(scores, labels)

    def _shapeContract(self, scores, labels):
        if labels.dtype != torch.int32:
            raise CostError("Cross entropy takes int32 labels, got %s" % labels.dtype)

        if scores.dim() != labels.dim() + 1 or tuple(scores.shape[2:]) != tuple(labels.shape[1:]):
            raise CostError("Cross entropy takes scores (batch, classes, *spatial) and labels (batch, *spatial), "
                            "got %s and %s" % (tuple(scores.shape), tuple(labels.shape)))

        if self.maxlabels and scores.shape[1] != self.maxlabels:
            raise CostError("Cross entropy expected %d classes, got %d" % (self.maxlabels, scores.shape[1]))
