"""Mean squared error (counterpart of ``puzzlelib_tpu/cost/mse.py``): the
gradient (target - pred) / size in the prediction's type, size the number
of target cells; the error sum(diff^2) * batch / (2 size), which
``getError`` divides by the batch; the validation error sum(diff^2) / (2
size) in f32."""

import numpy as np
import torch

from puzzlelib_tpu_torch.cost.cost import Cost, CostError


class MSE(Cost):
    def calcGrad(self, pred, target):
        c = 1.0 / np.prod(target.shape)
        grad = target.reshape(-1).to(pred.dtype) * c + pred.reshape(-1) * -c

        return grad.reshape(pred.shape)

    def calcError(self, pred, target):
        flat = self.grad.reshape(-1).float()
        dot = torch.sum(flat * flat).to(self.grad.dtype)

        self.devErr.copy_(dot * (np.prod(self.grad.shape) * self.grad.shape[0] / 2.0))
        self.accumErr.add_(self.devErr)

    def calcValDev(self, pred, target):
        diff = (target.float() - pred.float()).reshape(-1)
        return torch.sum(diff * diff) / (2.0 * float(np.prod(target.shape)))

    def checkDataShape(self, pred, target):
        self._shapeContract(pred, target)

    def checkValDataShape(self, pred, target):
        self._shapeContract(pred, target)

    @staticmethod
    def _shapeContract(pred, target):
        if tuple(pred.shape[1:]) != tuple(target.shape[1:]):
            raise CostError("MSE takes a prediction and a target of one shape, got %s and %s" %
                            (tuple(pred.shape), tuple(target.shape)))
