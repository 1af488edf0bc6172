"""Max-unpooling through a ``MaxPool2D``'s argmax mask (counterpart of
``puzzlelib_tpu/modules/maxunpool2d.py``): the constructor takes the
pooling module and turns its mask on; the forward scatters the data to the
cells the pool took its maxima from, on the maps the pool read
(``pool.inData``), adding where windows overlap; the backward gathers.

The pooling module is held as a plain attribute, not a child of this
``nn.Module``: it sits in the net already.  ``dataShapeFrom`` answers the
reference's extent, (n - 1) * stride + size - 2 * pad, which is short of
the pool's input where a floor pooling dropped a row (45 rows pool to 22,
which answers 44 while the forward restores 45), as the reference's
does.  Unlike the reference, it takes the types ``calcMode`` allows (a
bf16 SegNet)."""

from puzzlelib_tpu_torch.backend.kernels import pool as Pool
from puzzlelib_tpu_torch.modules.module import ModuleError, Module


def _unpooledHW(pool, pooledHW):
    """Spatial extent before pooling, from the tied module's geometry."""
    return tuple((n - 1) * stride + size - 2 * pad for n, size, stride, pad in
                 zip(pooledHW, pool.size, pool.stride, pool.pad))


def _pooledHW(pool, fullHW):
    """Spatial extent after pooling, inverse of :func:`_unpooledHW`."""
    return tuple((n + 2 * pad - size) // stride + 1 for n, size, stride, pad in
                 zip(fullHW, pool.size, pool.stride, pool.pad))


class MaxUnpool2D(Module):
    def __init__(self, maxpool2d, name=None):
        super().__init__(name)

        maxpool2d.withMask = True
        object.__setattr__(self, "maxpool2d", maxpool2d)

    def updateData(self, data):
        pool = self.maxpool2d
        self.data = Pool.maxunpool2d(data, pool.inData.shape, pool.mask, pool.size, pool.stride, pool.pad)

    def updateGrad(self, grad):
        pool = self.maxpool2d
        self.grad = Pool.maxunpool2dBackward(grad, pool.data.shape, pool.mask)

    def dataShapeFrom(self, shape):
        return tuple(shape[:2]) + _unpooledHW(self.maxpool2d, shape[2:])

    def gradShapeFrom(self, shape):
        return tuple(shape[:2]) + _pooledHW(self.maxpool2d, shape[2:])

    def checkDataShape(self, shape):
        maskShape = tuple(self.maxpool2d.mask.shape)
        if shape != maskShape:
            raise ModuleError("Data shape (current %s) must be equal to connected MaxPool2D mask shape (%s)" %
                              (shape, maskShape))

    def checkGradShape(self, shape):
        pooledInput = tuple(self.maxpool2d.inData.shape)
        if shape != pooledInput:
            raise ModuleError("Grad shape (current %s) must be equal to connected MaxPool2D data shape (%s)" %
                              (shape, pooledInput))

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
