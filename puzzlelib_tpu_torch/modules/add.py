"""Elementwise sum of a list of equal-shaped inputs (counterpart of
``puzzlelib_tpu/modules/add.py``): one n-ary add in the inputs' type; the
gradient fans out as one shared object (``movesGrad``)."""

from functools import reduce

import torch

from puzzlelib_tpu_torch.modules.module import ModuleError, Module


class Add(Module):
    def __init__(self, name=None):
        super().__init__(name)
        self.movesGrad = True

    def updateData(self, data):
        self.data = reduce(torch.add, data)

    def updateGrad(self, grad):
        # the sum's gradient fans out unchanged: every branch shares one object
        self.grad = [grad] * len(self.inData)

    def checkDataShape(self, shapes):
        for shape in shapes:
            if shape != shapes[0]:
                raise ModuleError("Shape %s is not equal to initial shape %s" % (shape, shapes[0]))

    def dataShapeFrom(self, shape):
        return shape[0]

    def gradShapeFrom(self, shape):
        return [shape] * len(self.inData)

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
