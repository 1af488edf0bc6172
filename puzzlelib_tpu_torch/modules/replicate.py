"""Fan-out of one input to ``times`` branches (counterpart of
``puzzlelib_tpu/modules/replicate.py``): every branch gets the same tensor,
and the backward sums the branches' gradients in the input's type, in
branch order, as the reference adds them one by one into a zero buffer."""

from functools import reduce

import torch

from puzzlelib_tpu_torch.modules.module import Module


class Replicate(Module):
    def __init__(self, times, name=None):
        super().__init__(name)
        self.registerBlueprint(locals())

        self.movesData = True
        self.times = times

    def updateData(self, data):
        self.data = [data] * self.times

    def updateGrad(self, grad):
        self.grad = reduce(torch.add, grad).to(grad[0].dtype)

    def dataShapeFrom(self, shape):
        return [shape] * self.times

    def gradShapeFrom(self, shape):
        return shape[0]

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
