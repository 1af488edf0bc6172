"""Sum over one axis (counterpart of ``puzzlelib_tpu/modules/sum.py``),
accumulated in f32 and cast back to the input's type.

With ``useWeights`` the module takes [data, v], v of data's shape up to and
including the axis, and sums data weighted by v along the axis; its gradient
is [data gradient, v gradient].  Without, the gradient is the output
gradient broadcast over the axis."""

import numpy as np

from puzzlelib_tpu_torch.ops import blas as _blas
from puzzlelib_tpu_torch.modules.module import ModuleError, Module


class Sum(Module):
    def __init__(self, axis, useWeights=True, name=None):
        super().__init__(name)
        self.registerBlueprint(locals())

        self.useWeights = useWeights
        self.axis = axis

        self.v = None
        self.axisSize = None

    def _grouped(self, data):
        """data as (before the axis, the axis, after the axis)."""
        pre = int(np.prod(data.shape[:self.axis]))
        return data.reshape(pre, data.shape[self.axis], -1)

    def updateData(self, batch):
        data, self.v = batch if self.useWeights else (batch, None)
        self.axisSize = data.shape[self.axis]

        if self.useWeights:
            grouped = self._grouped(data).float()
            out = (grouped * self.v.reshape(grouped.shape[:2] + (1, )).float()).sum(dim=1).to(data.dtype)
            self.data = out.reshape(data.shape[:self.axis] + data.shape[self.axis + 1:])
        else:
            self.data = _blas.matsum(data, self.axis, None, 1.0, 0.0)

    def updateGrad(self, grad):
        shape = grad.shape[:self.axis] + (self.axisSize, ) + grad.shape[self.axis:]
        outgrad = grad.unsqueeze(self.axis)

        if not self.useWeights:
            self.grad = outgrad.expand(shape).contiguous()
            return

        data = self.inData[0]
        weights = self.v.reshape(self.v.shape + (1, ) * (len(shape) - self.v.dim()))

        datagrad = (weights.float() * outgrad.float()).expand(shape).to(grad.dtype)
        wgrad = (self._grouped(data).float() * self._grouped(outgrad).float()).sum(dim=2).reshape(self.v.shape)

        self.grad = [datagrad.contiguous(), wgrad.to(self.v.dtype)]

    def dataShapeFrom(self, shapes):
        shape = shapes[0] if self.useWeights else shapes
        return shape[:self.axis] + shape[self.axis + 1:]

    def gradShapeFrom(self, shape):
        inshape = shape[:self.axis] + (self.axisSize, ) + shape[self.axis:]
        return [inshape, (self.axisSize, )] if self.useWeights else inshape

    def checkDataShape(self, shapes):
        if self.useWeights:
            shape, wshape = shapes

            if len(wshape) != self.axis + 1:
                raise ModuleError("Not enough dims in weights (%d were given, need at least %d)" %
                                  (len(wshape), self.axis + 1))

            if shape[:self.axis + 1] != wshape:
                raise ModuleError("Inconsistency in data and weights shapes (%s with %s)" % (shape, wshape))
        else:
            shape = shapes

        if self.axis > len(shape) - 1:
            raise ModuleError("Not enough dims in data (%d were given, need at least %d)" %
                              (len(shape), self.axis + 1))

    def checkGradShape(self, shape):
        if self.axis > len(shape):
            raise ModuleError("Not enough dims in grad (%d were given, need at least %d)" %
                              (len(shape), self.axis))

        if self.useWeights and shape[:self.axis] != tuple(self.v.shape[:self.axis]):
            raise ModuleError("Inconsistency in grad and weights shapes (%s with %s)" % (shape, tuple(self.v.shape)))

    def reset(self):
        super().reset()
        self.v = None
        self.axisSize = None

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
