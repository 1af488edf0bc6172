"""3-d pooling base (counterpart of ``puzzlelib_tpu/modules/pool3d.py``):
data (N, C, D, H, W); ``MaxPool3D`` and ``AvgPool3D`` set the mode.  The
backward is ``ops.pool.poolNdBackward``'s, which adds window cell by
window cell where windows overlap (``ops/pool.py``)."""

from puzzlelib_tpu_torch.backend.dnn import poolNd, poolNdBackward
from puzzlelib_tpu_torch.modules.module import ModuleError, Module


class Pool3D(Module):
    def __init__(self, size=2, stride=2, pad=0, name=None):
        super().__init__(name)

        self.gradUsesOutData = True

        self.size = self.repeat(size, 3)
        self.stride = self.repeat(stride, 3)
        self.pad = self.repeat(pad, 3)

        self.workspace = None
        self.mode = None

    def dataShapeFrom(self, shape):
        outspatial = tuple((shape[2 + i] + 2 * self.pad[i] - self.size[i]) // self.stride[i] + 1 for i in range(3))
        return tuple(shape[:2]) + outspatial

    def checkDataShape(self, shape):
        if len(shape) != 5:
            raise ModuleError("Data must be 5d tensor")

        for i in range(3):
            if shape[2 + i] + 2 * self.pad[i] < self.size[i]:
                raise ModuleError("Data spatial dim %d is too small (got %d, expected at least %d)" %
                                  (i, shape[2 + i] + 2 * self.pad[i], self.size[i]))

    def gradShapeFrom(self, shape):
        inspatial = tuple((shape[2 + i] - 1) * self.stride[i] - 2 * self.pad[i] + self.size[i] for i in range(3))
        return tuple(shape[:2]) + inspatial

    def checkGradShape(self, shape):
        if len(shape) != 5:
            raise ModuleError("Grad must be 5d tensor")

    def updateData(self, data):
        self.data, self.workspace = poolNd(
            data, size=self.size, stride=self.stride, pad=self.pad, mode=self.mode, test=not self.training
        )

    def updateGrad(self, grad):
        self.grad = poolNdBackward(self.inData, self.data, grad, self.workspace,
                                   size=self.size, stride=self.stride, pad=self.pad, mode=self.mode)

    def reset(self):
        super().reset()
        self.workspace = None

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
