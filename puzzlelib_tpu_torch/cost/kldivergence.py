"""KL divergence of a softmaxed prediction from a target distribution
(counterpart of ``puzzlelib_tpu/cost/kldivergence.py``): the softmax spans
every non-batch dim, flattened; ``normTarget`` softmaxes the target too;
``maxlabels`` fixes the prediction's second dim.  The stored batch error is
the divergence's sum over the batch, the validation error its mean
(``ops.cost.kldiv``)."""

import numpy as np

from puzzlelib_tpu_torch.ops import cost as costOps
from puzzlelib_tpu_torch.cost.cost import Cost, CostError, requireSampleShape


class KLDivergence(Cost):
    def __init__(self, maxlabels=None, normTarget=False):
        super().__init__()

        self.maxlabels = maxlabels
        self.normTarget = normTarget

    def _divergence(self, pred, target):
        """(mean divergence, grad) with the non-batch dims flattened, so that
        the softmax spans the whole sample."""
        flat = (pred.shape[0], int(np.prod(pred.shape[1:])))

        err, grad = costOps.kldiv(pred.reshape(flat), target.reshape(flat), normTarget=self.normTarget)
        return err, grad.reshape(pred.shape)

    def calcGrad(self, pred, target):
        err, grad = self._divergence(pred, target)

        # the stored error is the batch's sum: getError divides by the batch
        self.devErr.copy_(err * pred.shape[0])
        return grad

    def calcValDev(self, pred, target):
        err, _ = self._divergence(pred, target)
        return err

    def checkDataShape(self, pred, target):
        requireSampleShape("KL divergence", pred, target)

        if self.maxlabels and pred.shape[1] != self.maxlabels:
            raise CostError("KL divergence expected %d labels, got %d" % (self.maxlabels, pred.shape[1]))

    def checkValDataShape(self, pred, target):
        self.checkDataShape(pred, target)
