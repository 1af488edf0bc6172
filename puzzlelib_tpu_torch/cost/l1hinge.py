"""Pairwise L1-hinge embedding cost (counterpart of
``puzzlelib_tpu/cost/l1hinge.py``): the prediction is a pair [x1, x2] of
f32 (batch, size) embeddings, the labels int32 (batch, ), 1 for a similar
pair and 0 for a dissimilar one; error and the two gradients, one per
embedding, from ``ops.cost.l1Hinge``.  The validation error: the pairs
whose mean distance (similar within 1) misses their label, over the
batch."""

import torch

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.ops import cost as costOps
from puzzlelib_tpu_torch.cost.cost import Cost, CostError, requireLabelRange


class L1Hinge(Cost):
    def verifyLabels(self, labels):
        requireLabelRange("L1 Hinge", labels, 0, 1)

    def calcGrad(self, pair, labels):
        if Config.verifyData:
            self.verifyLabels(labels)

        err, g1, g2 = costOps.l1Hinge(pair[0], pair[1], labels)
        self.devErr.copy_(err)
        return [g1, g2]

    def calcValDev(self, pair, labels):
        if Config.verifyData:
            self.verifyLabels(labels)

        dist = (pair[0] - pair[1]).abs().mean(dim=1)
        return ((dist <= 1.0) != labels.bool()).sum().float() / pair[0].shape[0]

    def getBatchsize(self, pair):
        return pair[0].shape[0]

    def checkDataShape(self, pair, labels):
        self._shapeContract(pair, labels)

    def checkValDataShape(self, pair, labels):
        self._shapeContract(pair, labels)

    @staticmethod
    def _shapeContract(pair, labels):
        x1, x2 = pair
        if x1.dim() != 2 or tuple(x1.shape) != tuple(x2.shape):
            raise CostError("L1 Hinge takes a pair of (batch, size) embeddings of one shape, got %s and %s" %
                            (tuple(x1.shape), tuple(x2.shape)))

        if x1.dtype != torch.float32 or x2.dtype != torch.float32 or labels.dtype != torch.int32:
            raise CostError("L1 Hinge takes f32 embeddings and int32 labels, got %s, %s and %s" %
                            (x1.dtype, x2.dtype, labels.dtype))
