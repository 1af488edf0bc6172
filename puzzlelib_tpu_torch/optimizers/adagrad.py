"""AdaGrad (counterpart of ``puzzlelib_tpu/optimizers/adagrad.py``): per
state the sum of squared gradients ``h`` of the variable's shape and type,
and the step ``ops.elementwise.adagrad_`` in place."""

import torch

from puzzlelib_tpu_torch.ops import elementwise as ew
from puzzlelib_tpu_torch.optimizers.optimizer import Optimizer


class AdaGrad(Optimizer):
    def __init__(self, learnRate=1e-3, epsilon=1e-8, nodeinfo=None):
        super().__init__(nodeinfo)

        self.epsilon = None

        self.setAttr("learnRate", learnRate)
        self.setAttr("epsilon", epsilon)

    def setupState(self, var):
        return {"h": torch.zeros_like(var.data)}

    def updateVar(self, var, state):
        ew.adagrad_(var.data, var.grad, state["h"], self.learnRate * var.learnRate, self.epsilon)
