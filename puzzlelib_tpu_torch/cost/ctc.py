"""CTC cost (counterpart of ``puzzlelib_tpu/cost/ctc.py``): the prediction is
(scores (T, B, V), datalen (B, )), the target (labels concatenated,
lengths (B, )), all three int32; the gradient is ``ops.ctc``'s, the
descent direction in f32, and the error the sum of the per-sample NLLs,
which ``getError`` divides by the batch."""

import torch

from puzzlelib_tpu_torch.backend.kernels.costs import ctcLoss
from puzzlelib_tpu_torch.cost.cost import Cost, CostError


class CTC(Cost):
    def __init__(self, blank, vocabsize=None, normalized=False):
        super().__init__()

        self.normalized = normalized

        if vocabsize is not None and not 0 <= blank <= vocabsize:
            raise CostError("blank %s outside the vocabulary of %s" % (blank, vocabsize))

        self.vocabsize = vocabsize
        self.blank = blank

    def calcGrad(self, pred, target):
        data, datalen = pred
        labels, lengths = target

        _, grad = ctcLoss(data, datalen, labels, lengths, self.blank, error=self.devErr, normalized=self.normalized)
        return grad

    def calcVal(self, pred, target):
        raise NotImplementedError()

    def calcValDev(self, pred, target):
        raise NotImplementedError()

    def checkDataShape(self, pred, target):
        data, datalen = pred
        labels, lengths = target

        if not datalen.dtype == labels.dtype == lengths.dtype == torch.int32:
            raise CostError("CTC takes int32 datalen, labels and lengths, got %s, %s and %s" %
                            (datalen.dtype, labels.dtype, lengths.dtype))

        if not datalen.shape[0] == lengths.shape[0] == data.shape[1]:
            raise CostError("CTC takes datalen and lengths of the batch %d, got %d and %d" %
                            (data.shape[1], datalen.shape[0], lengths.shape[0]))

        if self.vocabsize is not None and data.shape[2] != self.vocabsize:
            raise CostError("CTC scores have %d symbols, the vocabulary %d" % (data.shape[2], self.vocabsize))

    def getBatchsize(self, pred):
        return pred[0].shape[1]
