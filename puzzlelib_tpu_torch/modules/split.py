"""Split along one axis into sections (counterpart of
``puzzlelib_tpu/modules/split.py``): the forward's pieces are copies, as
the reference's are, so that a later inplace write to the input does not
show in them; the backward concatenates the gradients."""

import torch

from puzzlelib_tpu_torch.modules.module import ModuleError, Module


class Split(Module):
    def __init__(self, axis, sections, name=None):
        super().__init__(name)
        self.registerBlueprint(locals())

        self.sections = sections
        self.axis = axis

    def updateData(self, data):
        self.data = [part.clone() for part in torch.split(data, list(self.sections), dim=self.axis)]

    def updateGrad(self, grad):
        self.grad = torch.cat(grad, dim=self.axis)

    def dataShapeFrom(self, shape):
        return [tuple(shape[:self.axis]) + (sec, ) + tuple(shape[self.axis + 1:]) for sec in self.sections]

    def gradShapeFrom(self, shapes):
        concatDim = sum(shape[self.axis] for shape in shapes)
        return tuple(shapes[0][:self.axis]) + (concatDim, ) + tuple(shapes[0][self.axis + 1:])

    def checkDataShape(self, shape):
        if len(shape) < self.axis:
            raise ModuleError("Not enough dims in data (%d were given, need at least %d)" % (len(shape), self.axis))

        concatDim = sum(self.sections)
        if concatDim != shape[self.axis]:
            raise ModuleError(
                "Data shape %s is inconsistent with given sections %s "
                "(expected size %d on axis %d, %d was given)" %
                (shape, self.sections, concatDim, self.axis, shape[self.axis])
            )

    def checkGradShape(self, shapes):
        for i, shape in enumerate(shapes):
            if shape != tuple(self.data[i].shape):
                raise ModuleError(
                    "Expected grad shape %s on %d place (%s was given)" % (tuple(self.data[i].shape), i + 1, shape)
                )

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
