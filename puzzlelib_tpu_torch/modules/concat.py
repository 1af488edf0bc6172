"""Concatenation of a list of tensors along ``axis`` (counterpart of
``puzzlelib_tpu/modules/concat.py``): the forward is ``torch.cat``, the
backward ``torch.split`` of the gradient into the inputs' sections, views of
it in the inputs' order (the U-Net's skip connections, the Inception
branches)."""

import torch

from puzzlelib_tpu_torch.modules.module import ModuleError, Module


class Concat(Module):
    def __init__(self, axis, name=None):
        super().__init__(name)

        self.axis = axis
        self.sections = None

    def updateData(self, data):
        self.sections = [d.shape[self.axis] for d in data]
        self.data = torch.cat(data, dim=self.axis)

    def updateGrad(self, grad):
        self.grad = list(torch.split(grad, self.sections, dim=self.axis))

    def checkDataShape(self, shapes):
        for i, shape in enumerate(shapes[1:]):
            if not shape[:self.axis] + shape[self.axis + 1:] == shapes[0][:self.axis] + shapes[0][self.axis + 1:]:
                raise ModuleError(
                    "Shape %d is inconsistent with initial shape (checking %s, init is %s)" % (i, shape, shapes[0])
                )

    def dataShapeFrom(self, shapes):
        concatDim = sum(shape[self.axis] for shape in shapes)
        return shapes[0][:self.axis] + (concatDim, ) + shapes[0][self.axis + 1:]

    def checkGradShape(self, shape):
        concatDim = sum(self.sections)
        gradShape = tuple(self.data.shape[:self.axis]) + (concatDim, ) + tuple(self.data.shape[self.axis + 1:])

        if gradShape != shape:
            raise ModuleError("Expected grad shape %s (given %s)" % (gradShape, shape))

    def gradShapeFrom(self, shape):
        return [shape[:self.axis] + (sec, ) + shape[self.axis + 1:] for sec in self.sections]

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
