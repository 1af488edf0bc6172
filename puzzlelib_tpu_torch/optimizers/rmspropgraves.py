"""Graves' RMSProp with momentum (counterpart of
``puzzlelib_tpu/optimizers/rmspropgraves.py``): per state the running means
of gradients ``mg`` and squared gradients ``ms`` and the step ``delta``, of
the variable's shape and type, and the step
``ops.elementwise.rmspropGraves_`` in place."""

import torch

from puzzlelib_tpu_torch.ops import elementwise as ew
from puzzlelib_tpu_torch.optimizers.optimizer import Optimizer


class RMSPropGraves(Optimizer):
    def __init__(self, learnRate=1e-4, alpha=0.95, momRate=0.9, epsilon=1e-4, nodeinfo=None):
        super().__init__(nodeinfo)

        self.alpha = None
        self.momRate = None
        self.epsilon = None

        self.setAttr("learnRate", learnRate)
        self.setAttr("alpha", alpha)
        self.setAttr("momRate", momRate)
        self.setAttr("epsilon", epsilon)

    def setupState(self, var):
        return {name: torch.zeros_like(var.data) for name in ("mg", "ms", "delta")}

    def updateVar(self, var, state):
        ew.rmspropGraves_(var.data, var.grad, state["mg"], state["ms"], state["delta"],
                          self.learnRate * var.learnRate, self.alpha, self.momRate * var.momRate, self.epsilon)
