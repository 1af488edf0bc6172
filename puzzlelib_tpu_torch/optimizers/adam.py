"""Adam (counterpart of ``puzzlelib_tpu/optimizers/adam.py``): per state the
f32 moments ``mg`` and ``ms`` of the variable's shape (of a dtype's flat
buffer under global state), and the step ``ops.elementwise.adam_`` in place
with the bias correction folded into the rate, as in the reference."""

import math

import torch

from puzzlelib_tpu_torch.ops import elementwise as ew
from puzzlelib_tpu_torch.optimizers.optimizer import Optimizer


class Adam(Optimizer):
    def __init__(self, alpha=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8):
        super().__init__()

        self.alpha = None
        self.beta1 = None
        self.beta2 = None
        self.epsilon = None

        self.setAttr("alpha", alpha)
        self.setAttr("beta1", beta1)
        self.setAttr("beta2", beta2)
        self.setAttr("epsilon", epsilon)

    def setupState(self, var):
        return {
            "mg": torch.zeros(var.data.shape, dtype=torch.float32, device=var.data.device),
            "ms": torch.zeros(var.data.shape, dtype=torch.float32, device=var.data.device),
        }

    def updateVar(self, var, state):
        fix1, fix2 = 1.0 - self.beta1 ** self.t, 1.0 - self.beta2 ** self.t
        self.learnRate = self.alpha * math.sqrt(fix2) / fix1

        ew.adam_(var.data, var.grad, state["mg"], state["ms"], self.learnRate * var.learnRate,
                 1.0 - self.beta1, 1.0 - self.beta2, self.epsilon)
