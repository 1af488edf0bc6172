"""2-D average pooling (counterpart of ``puzzlelib_tpu/modules/avgpool2d.py``):
``includePad`` counts the pad cells in each window's divisor."""

from puzzlelib_tpu_torch.backend.dnn import PoolMode, poolNd, poolNdBackward
from puzzlelib_tpu_torch.modules.pool2d import Pool2D


class AvgPool2D(Pool2D):
    def __init__(self, size=2, stride=2, pad=0, includePad=True, name=None):
        super().__init__(size, stride, pad, name)
        self.registerBlueprint(locals())
        self.mode = PoolMode.avgWithPad if includePad else PoolMode.avgNoPad

    def updateData(self, data):
        self.data, self.workspace = poolNd(
            data, size=self.size, stride=self.stride, pad=self.pad, mode=self.mode, test=not self.training
        )

    def updateGrad(self, grad):
        self.grad = poolNdBackward(self.inData, self.data, grad, self.workspace,
                                   size=self.size, stride=self.stride, pad=self.pad, mode=self.mode)
