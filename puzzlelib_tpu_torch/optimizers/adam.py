"""Adam (counterpart of ``puzzlelib_tpu/optimizers/adam.py``): per state the
f32 moments ``mg`` and ``ms`` of the variable's shape (of a dtype's flat
buffer under global state), and the step ``ops.elementwise.adam_`` in place
with the bias correction folded into the rate, as in the reference.  Inside
a fused step (``fusedctx``) the step count and the hyper-parameters are 0-d
f32 tensors on the device and the rate is computed there in f32, as the
reference's traced step computes it; the eager step computes it on the host
in f64."""

import math

import torch

from puzzlelib_tpu_torch import fusedctx
from puzzlelib_tpu_torch.ops import elementwise as ew
from puzzlelib_tpu_torch.optimizers.optimizer import Optimizer


class Adam(Optimizer):
    def __init__(self, alpha=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8, nodeinfo=None):
        super().__init__(nodeinfo)

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
        t = fusedctx.stepOr(self.t)
        fix1, fix2 = 1.0 - self.beta1 ** t, 1.0 - self.beta2 ** t

        if fusedctx.active():
            # t and the hyper-parameters are 0-d f32 tensors on the device:
            # the rate in f32 there, as the reference's traced step takes it
            self.learnRate = self.alpha * torch.sqrt(fix2) / fix1
        else:
            self.learnRate = self.alpha * math.sqrt(fix2) / fix1

        ew.adam_(var.data, var.grad, state["mg"], state["ms"], self.learnRate * var.learnRate,
                 1.0 - self.beta1, 1.0 - self.beta2, self.epsilon)
