"""Plain SGD (counterpart of ``puzzlelib_tpu/optimizers/sgd.py``)."""

from puzzlelib_tpu_torch.ops import elementwise as ew
from puzzlelib_tpu_torch.optimizers.optimizer import Optimizer


class SGD(Optimizer):
    def __init__(self, learnRate=1e-3, nodeinfo=None):
        super().__init__(nodeinfo)
        self.setAttr("learnRate", learnRate)

    def updateVar(self, var, state):
        ew.toVectorAddVector_(var.data, var.grad, self.learnRate * var.learnRate)
