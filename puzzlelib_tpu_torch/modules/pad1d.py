"""1-d padding of (N, C, T) data (counterpart of
``puzzlelib_tpu/modules/pad1d.py``): "constant" fills the margins with
``fillValue``, "reflect" mirrors the data about its edge cells
(``backend.kernels.pad``).  ``pad`` is one width for both sides or (lpad,
rpad).

The constant mode keeps the input's type, where the reference allocates its
output in f32 whatever the input's type (so a bf16 net's next module refuses
it); the backward slices the gradient."""

from enum import Enum

import torch

from puzzlelib_tpu_torch.backend.kernels import pad as Pad
from puzzlelib_tpu_torch.modules.module import ModuleError, Module


class PadMode(str, Enum):
    constant = "constant"
    reflect = "reflect"


class Pad1D(Module):
    def __init__(self, pad, mode="constant", fillValue=None, name=None):
        super().__init__(name)
        self.registerBlueprint(locals())

        self.mode = PadMode(mode)
        self.pad = self.repeat(pad, 2)
        self.fillValue = 0 if fillValue is None else fillValue

    def updateData(self, data):
        lpad, rpad = self.pad

        if self.mode == PadMode.constant:
            self.data = torch.nn.functional.pad(data, (lpad, rpad), mode="constant", value=self.fillValue)
        else:
            self.data = Pad.reflectpad1d(data, self.pad)

    def updateGrad(self, grad):
        lpad, rpad = self.pad

        if self.mode == PadMode.constant:
            self.grad = grad[:, :, lpad:grad.shape[2] - rpad].contiguous()
        else:
            self.grad = Pad.reflectpad1dBackward(grad, self.pad)

    def checkDataShape(self, shape):
        if len(shape) != 3:
            raise ModuleError("Data must be 3d tensor")

    def checkGradShape(self, shape):
        if len(shape) != 3:
            raise ModuleError("Grad must be 3d tensor")

        lpad, rpad = self.pad
        if shape[2] < lpad + rpad + 1:
            raise ModuleError("Grad size is too small (got %d, expected >= %d)" % (shape[2], lpad + rpad + 1))

    def dataShapeFrom(self, shape):
        batchsize, maps, insize = shape
        lpad, rpad = self.pad

        return batchsize, maps, insize + lpad + rpad

    def gradShapeFrom(self, shape):
        batchsize, maps, outsize = shape
        lpad, rpad = self.pad

        return batchsize, maps, outsize - lpad - rpad

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
