"""2-D max pooling (counterpart of ``puzzlelib_tpu/modules/maxpool2d.py``).
The masked variant (``useMask``, for MaxUnpool2D) comes with that module."""

from puzzlelib_tpu_torch.backend.dnn import PoolMode, poolNd, poolNdBackward
from puzzlelib_tpu_torch.modules.pool2d import Pool2D


class MaxPool2D(Pool2D):
    def __init__(self, size=2, stride=2, pad=0, name=None):
        super().__init__(size, stride, pad, name)
        self.mode = PoolMode.max

    def updateData(self, data):
        self.data, self.workspace = poolNd(
            data, size=self.size, stride=self.stride, pad=self.pad, mode=self.mode, test=not self.training
        )

    def updateGrad(self, grad):
        self.grad = poolNdBackward(self.inData, self.data, grad, self.workspace,
                                   size=self.size, stride=self.stride, pad=self.pad, mode=self.mode)
