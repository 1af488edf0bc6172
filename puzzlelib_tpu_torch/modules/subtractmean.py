"""Subtractive normalization (counterpart of
``puzzlelib_tpu/modules/subtractmean.py``): each cell less the mean of its
``size`` x ``size`` window (an average pool at stride 1, pad size // 2, pad
cells counted or not as ``includePad`` says); the backward is the gradient
less the pool's backward of it.  f32 only, as in the reference."""

from puzzlelib_tpu_torch.backend.dnn import PoolMode, poolNd, poolNdBackward
from puzzlelib_tpu_torch.modules.module import ModuleError, Module


class SubtractMean(Module):
    def __init__(self, size=5, includePad=True, name=None):
        super().__init__(name)

        if size % 2 != 1 or size == 1:
            raise ModuleError("Subtractive norm size must be odd and > 1")

        self.size = self.repeat(size, 2)
        self.pad = (self.size[0] // 2, self.size[1] // 2)
        self.mode = PoolMode.avgWithPad if includePad else PoolMode.avgNoPad

        self.means = None
        self.workspace = None

    def updateData(self, data):
        self.means, self.workspace = poolNd(
            data, size=self.size, stride=(1, 1), pad=self.pad, mode=self.mode, test=not self.training
        )
        self.data = data - self.means

    def updateGrad(self, grad):
        meansGrad = poolNdBackward(self.inData, self.means, grad, self.workspace,
                                   size=self.size, stride=(1, 1), pad=self.pad, mode=self.mode)
        self.grad = grad - meansGrad

    def reset(self):
        super().reset()
        self.means = self.workspace = None

    def dataShapeFrom(self, shape):
        return shape

    def gradShapeFrom(self, shape):
        return shape

    def checkDataShape(self, shape):
        if len(shape) != 4:
            raise ModuleError("Data must be 4d tensor")

    def checkGradShape(self, shape):
        if len(shape) != 4:
            raise ModuleError("Grad must be 4d tensor")
