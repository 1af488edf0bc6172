"""Subtensor extraction (counterpart of ``puzzlelib_tpu/modules/slice.py``),
configured as ``Slice()[:, 1:-1]``.  The forward copies the subtensor, as
the reference does, so that an inplace module after it writes its own
tensor and not the input; the backward writes the gradient into zeros of
the input's shape, in the gradient's type.  Unlike the reference, it takes
the types ``calcMode`` allows."""

import torch

from puzzlelib_tpu_torch.modules.module import ModuleError, Module


class Slice(Module):
    def __init__(self, slc=None, name=None):
        super().__init__(name)
        self.registerBlueprint(locals())

        self.slc = slc
        self.inshape = None

    def __getitem__(self, slc):
        self.slc = slc if isinstance(slc, tuple) else (slc, )
        return self

    def _requireSlice(self):
        if self.slc is None:
            raise ModuleError("Slice parameter is not initialized")

    def updateData(self, data):
        self.inshape = tuple(data.shape)
        self.data = data[self.slc].clone()

    def updateGrad(self, grad):
        full = torch.zeros(self.inshape, dtype=grad.dtype, device=grad.device)
        full[self.slc] = grad
        self.grad = full

    def dataShapeFrom(self, shape):
        self._requireSlice()

        # unspecified trailing axes pass through whole
        window = self.slc + (slice(None), ) * (len(shape) - len(self.slc))

        return tuple(len(range(*slc.indices(extent))) for slc, extent in zip(window, shape))

    def checkDataShape(self, shape):
        self._requireSlice()

        if len(shape) < len(self.slc):
            raise ModuleError("Expected at least %d data dimensions, %d were given" % (len(self.slc), len(shape)))

    def gradShapeFrom(self, shape):
        return self.inshape

    def checkGradShape(self, shape):
        if shape != tuple(self.data.shape):
            raise ModuleError("Grad shape %s is inconsistent with output data shape %s" %
                              (shape, tuple(self.data.shape)))

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
