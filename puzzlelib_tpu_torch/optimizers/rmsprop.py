"""RMSProp (counterpart of ``puzzlelib_tpu/optimizers/rmsprop.py``): per
state the running mean of squared gradients ``ms`` of the variable's shape
and type, and the step ``ops.elementwise.rmsprop_`` in place."""

import torch

from puzzlelib_tpu_torch.ops import elementwise as ew
from puzzlelib_tpu_torch.optimizers.optimizer import Optimizer


class RMSProp(Optimizer):
    def __init__(self, learnRate=1e-3, factor=0.9, epsilon=1e-5, nodeinfo=None):
        super().__init__(nodeinfo)

        self.factor = None
        self.epsilon = None

        self.setAttr("learnRate", learnRate)
        self.setAttr("factor", factor)
        self.setAttr("epsilon", epsilon)

    def setupState(self, var):
        return {"ms": torch.zeros_like(var.data)}

    def updateVar(self, var, state):
        ew.rmsprop_(var.data, var.grad, state["ms"], self.learnRate * var.learnRate, self.factor, self.epsilon)
