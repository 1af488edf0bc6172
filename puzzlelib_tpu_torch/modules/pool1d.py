"""1-d pooling base (counterpart of ``puzzlelib_tpu/modules/pool1d.py``): as
in the JAX package, data (N, C, T) is pooled as (N, C, T, 1) by the 2-d
pools on a (size, 1) window (``backend.dnn.poolNd``), so the 1-d branch of
``ops.pool`` stays unused.  ``MaxPool1D`` and ``AvgPool1D`` set the mode."""

from puzzlelib_tpu_torch.backend.dnn import poolNd, poolNdBackward
from puzzlelib_tpu_torch.modules.module import ModuleError, Module


class Pool1D(Module):
    def __init__(self, size=2, stride=2, pad=0, name=None):
        super().__init__(name)

        self.gradUsesOutData = True

        self.size = size
        self.stride = stride
        self.pad = pad

        self.workspace = None
        self.mode = None

    def dataShapeFrom(self, shape):
        batchsize, maps, insize = shape
        outsize = (insize + 2 * self.pad - self.size) // self.stride + 1

        return batchsize, maps, outsize

    def checkDataShape(self, shape):
        if len(shape) != 3:
            raise ModuleError("Data must be 3d tensor")

        if shape[2] + 2 * self.pad < self.size:
            raise ModuleError("Data size is too small (got %d, expected at least %d)" %
                              (shape[2] + 2 * self.pad, self.size))

    def gradShapeFrom(self, shape):
        batchsize, maps, outsize = shape
        insize = (outsize - 1) * self.stride - 2 * self.pad + self.size

        return batchsize, maps, insize

    def checkGradShape(self, shape):
        if len(shape) != 3:
            raise ModuleError("Grad must be 3d tensor")

    def _window(self):
        return dict(size=(self.size, 1), stride=(self.stride, 1), pad=(self.pad, 0), mode=self.mode)

    def updateData(self, data):
        outdata, self.workspace = poolNd(data.unsqueeze(-1), test=not self.training, **self._window())
        self.data = outdata.squeeze(-1)

    def updateGrad(self, grad):
        ingrad = poolNdBackward(self.inData.unsqueeze(-1), self.data.unsqueeze(-1), grad.unsqueeze(-1),
                                self.workspace, **self._window())
        self.grad = ingrad.squeeze(-1)

    def reset(self):
        super().reset()
        self.workspace = None

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
