"""SGD with classic momentum (counterpart of
``puzzlelib_tpu/optimizers/momentumsgd.py``): per state a momentum buffer
``mom`` of the variable's shape and type."""

import torch

from puzzlelib_tpu_torch.ops import elementwise as ew
from puzzlelib_tpu_torch.optimizers.sgd import SGD


class MomentumSGD(SGD):
    def __init__(self, learnRate=1e-3, momRate=0.9, nodeinfo=None):
        super().__init__(learnRate, nodeinfo)

        self.momRate = None
        self.setAttr("momRate", momRate)

    def setupState(self, var):
        return {"mom": torch.zeros_like(var.data)}

    def updateVar(self, var, state):
        ew.classicMomSGD_(var.data, var.grad, state["mom"], self.learnRate * var.learnRate,
                          self.momRate * var.momRate)
