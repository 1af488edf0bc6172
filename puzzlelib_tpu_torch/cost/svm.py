"""One-vs-rest multiclass SVM with L1 or squared (L2) margins (counterpart
of ``puzzlelib_tpu/cost/svm.py``): scores (batch, classes, *spatial),
int32 labels (batch, *spatial), error and descent gradient from
``ops.cost.svm``.  The validation error is the share of argmax predictions
that miss their labels, over the batch; ``calcValDev`` keeps the
predictions in ``mostProb``, as the reference's does (under a recorded
``FusedValidator`` too: the last batch's)."""

import torch

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.ops import cost as costOps
from puzzlelib_tpu_torch.cost.cost import Cost, CostError, requireLabelRange


class SVM(Cost):
    def __init__(self, mode="l1"):
        super().__init__()

        self.mode = mode
        self.mostProb = None

    def reset(self):
        super().reset()
        self.mostProb = None

    def verifyLabels(self, scores, labels):
        requireLabelRange("SVM", labels, 0, scores.shape[1] - 1)

    def calcGrad(self, scores, labels):
        if Config.verifyData:
            self.verifyLabels(scores, labels)

        err, grad = costOps.svm(scores, labels, mode=self.mode)
        self.devErr.copy_(err)
        return grad

    def calcValDev(self, scores, labels):
        if Config.verifyData:
            self.verifyLabels(scores, labels)

        self.mostProb = torch.argmax(scores, dim=1).to(torch.int32)
        return costOps.accuracy(self.mostProb, labels) / scores.shape[0]

    def checkDataShape(self, scores, labels):
        if labels.dtype != torch.int32:
            raise CostError("SVM takes int32 labels, got %s" % labels.dtype)

        if scores.dim() != labels.dim() + 1 or tuple(scores.shape[2:]) != tuple(labels.shape[1:]):
            raise CostError("SVM takes scores (batch, classes, *spatial) and labels (batch, *spatial), got %s and "
                            "%s" % (tuple(scores.shape), tuple(labels.shape)))

    def checkValDataShape(self, scores, labels):
        self.checkDataShape(scores, labels)
