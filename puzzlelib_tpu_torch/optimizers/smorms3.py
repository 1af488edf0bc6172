"""SMORMS3 (counterpart of ``puzzlelib_tpu/optimizers/smorms3.py``): per
state the memory ``mem`` (ones) and the running means ``mg`` and ``ms``, of
the variable's shape and f32 whatever the variable's type, as in the
reference, and the step ``ops.elementwise.smorms3_`` in place."""

import torch

from puzzlelib_tpu_torch.ops import elementwise as ew
from puzzlelib_tpu_torch.optimizers.optimizer import Optimizer


class SMORMS3(Optimizer):
    def __init__(self, learnRate=1e-3, epsilon=1e-16, nodeinfo=None):
        super().__init__(nodeinfo)

        self.epsilon = None

        self.setAttr("learnRate", learnRate)
        self.setAttr("epsilon", epsilon)

    def setupState(self, var):
        shape, device = var.data.shape, var.data.device
        return {
            "mem": torch.ones(shape, dtype=torch.float32, device=device),
            "mg": torch.zeros(shape, dtype=torch.float32, device=device),
            "ms": torch.zeros(shape, dtype=torch.float32, device=device),
        }

    def updateVar(self, var, state):
        ew.smorms3_(var.data, var.grad, state["mem"], state["mg"], state["ms"], self.learnRate * var.learnRate,
                    self.epsilon)
