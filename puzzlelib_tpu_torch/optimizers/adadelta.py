"""AdaDelta (counterpart of ``puzzlelib_tpu/optimizers/adadelta.py``): per
state the running means of squared gradients ``msg`` and of squared steps
``msdx``, of the variable's shape and type, and the step
``ops.elementwise.adadelta_`` in place.  ``learnRate`` is 1.0, as in the
reference, and the step never reads it (a fused step carries it as a 0-d
tensor all the same, as it carries every numeric attribute)."""

import torch

from puzzlelib_tpu_torch.ops import elementwise as ew
from puzzlelib_tpu_torch.optimizers.optimizer import Optimizer


class AdaDelta(Optimizer):
    def __init__(self, rho=0.95, epsilon=1e-6, nodeinfo=None):
        super().__init__(nodeinfo)

        self.rho = None
        self.epsilon = None

        self.setAttr("rho", rho)
        self.setAttr("epsilon", epsilon)

        self.learnRate = 1.0

    def setupState(self, var):
        return {"msg": torch.zeros_like(var.data), "msdx": torch.zeros_like(var.data)}

    def updateVar(self, var, state):
        ew.adadelta_(var.data, var.grad, state["msg"], state["msdx"], self.rho, self.epsilon)
