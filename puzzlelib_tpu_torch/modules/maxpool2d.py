"""2-D max pooling (counterpart of ``puzzlelib_tpu/modules/maxpool2d.py``).
With ``useMask`` (set by a ``MaxUnpool2D`` tied to it) the forward keeps
each window's argmax as ``mask`` (``backend.kernels.pool``), which the
backward and the unpool scatter through; the mask is a tensor of the
forward that made it, so a fused step's recording reads the one it wrote."""

from puzzlelib_tpu_torch.backend.kernels import pool as Pool
from puzzlelib_tpu_torch.backend.dnn import PoolMode, poolNd, poolNdBackward
from puzzlelib_tpu_torch.modules.pool2d import Pool2D


class MaxPool2D(Pool2D):
    def __init__(self, size=2, stride=2, pad=0, useMask=False, name=None):
        super().__init__(size, stride, pad, name)
        self.registerBlueprint(locals())

        self.useMask = useMask
        self.mask = None
        self.mode = PoolMode.max

    @property
    def withMask(self):
        return self.useMask

    @withMask.setter
    def withMask(self, val):
        self.useMask = val
        self.gradUsesOutData = not val

    def updateData(self, data):
        if self.useMask:
            self.data, self.mask = Pool.maxpool2d(data, size=self.size, stride=self.stride, pad=self.pad)
        else:
            self.data, self.workspace = poolNd(
                data, size=self.size, stride=self.stride, pad=self.pad, mode=self.mode, test=not self.training
            )

    def updateGrad(self, grad):
        if self.useMask:
            self.grad = Pool.maxpool2dBackward(grad, self.inData.shape, self.mask,
                                               size=self.size, stride=self.stride, pad=self.pad)
        else:
            self.grad = poolNdBackward(self.inData, self.data, grad, self.workspace,
                                       size=self.size, stride=self.stride, pad=self.pad, mode=self.mode)

    def reset(self):
        super().reset()
        self.mask = None
