"""2-d padding of (N, C, H, W) data (counterpart of
``puzzlelib_tpu/modules/pad2d.py``): "constant" fills the margins with
``fillValue``, "reflect" mirrors the data about its edge cells
(``backend.kernels.pad``).  ``pad`` is one width for every side or (up,
bottom, left, right).

The constant mode keeps the input's type, where the reference casts its
output to f32 whatever the input's type, as ``Pad1D``'s does; the backward
slices the gradient."""

import torch

from puzzlelib_tpu_torch.backend.kernels import pad as Pad
from puzzlelib_tpu_torch.modules.module import ModuleError, Module
from puzzlelib_tpu_torch.modules.pad1d import PadMode


class Pad2D(Module):
    def __init__(self, pad, mode="constant", fillValue=None, name=None):
        super().__init__(name)

        self.mode = PadMode(mode)
        self.pad = self.repeat(pad, 4)
        self.fillValue = 0 if fillValue is None else fillValue

    def updateData(self, data):
        up, bottom, left, right = self.pad

        if self.mode == PadMode.reflect:
            self.data = Pad.reflectpad2d(data, self.pad)
        else:
            self.data = torch.nn.functional.pad(data, (left, right, up, bottom), mode="constant",
                                                value=self.fillValue)

    def updateGrad(self, grad):
        up, bottom, left, right = self.pad

        if self.mode == PadMode.reflect:
            self.grad = Pad.reflectpad2dBackward(grad, self.pad)
        else:
            h, w = grad.shape[2:]
            self.grad = grad[:, :, up:h - bottom, left:w - right].contiguous()

    def dataShapeFrom(self, shape):
        n, c, h, w = shape
        up, bottom, left, right = self.pad
        return n, c, h + up + bottom, w + left + right

    def gradShapeFrom(self, shape):
        n, c, h, w = shape
        up, bottom, left, right = self.pad
        return n, c, h - up - bottom, w - left - right

    def checkDataShape(self, shape):
        if len(shape) != 4:
            raise ModuleError("Data must be 4d tensor")

    def checkGradShape(self, shape):
        if len(shape) != 4:
            raise ModuleError("Grad must be 4d tensor")

        up, bottom, left, right = self.pad
        h, w = shape[2:]

        if h < up + bottom + 1:
            raise ModuleError("Grad maps height is too small (got %d, expected >= %d)" % (h, up + bottom + 1))

        if w < left + right + 1:
            raise ModuleError("Grad maps width is too small (got %d, expected >= %d)" % (w, left + right + 1))

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
