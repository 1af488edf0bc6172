"""Regularization penalty (counterpart of ``puzzlelib_tpu/modules/penalty.py``):
the forward is the identity; the backward takes from the incoming gradient
weight / batch times sign(data) ("l1", with sign(0) = +1, as the
reference's kernel) or times data ("l2").  f32 only, as in the reference."""

from enum import Enum

from puzzlelib_tpu_torch.ops import elementwise as ew
from puzzlelib_tpu_torch.modules.module import Module


class PenaltyMode(str, Enum):
    l1 = "l1"
    l2 = "l2"


class Penalty(Module):
    def __init__(self, mode="l1", weight=1e-2, name=None):
        super().__init__(name)

        self.gradUsesOutData = True
        self.movesData = True

        self.mode = PenaltyMode(mode)
        self.weight = weight

    def updateData(self, data):
        self.data = data

    def updateGrad(self, grad):
        strength = self.weight / grad.shape[0]

        if self.mode == PenaltyMode.l1:
            self.grad = ew.l1penalty(grad, self.data, strength)
        else:
            self.grad = ew.l2penalty(grad, self.data, strength)

    def dataShapeFrom(self, shape):
        return shape

    gradShapeFrom = dataShapeFrom
