"""Shape-changing pass-through (counterpart of
``puzzlelib_tpu/modules/reshape.py``): a 0 in the target shape copies that
axis from the input, a -1 is inferred.  Both passes are ``reshape``: a view
where the layout allows it, else a copy."""

import numpy as np

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.modules.module import ModuleError, Module


def _volume(shape):
    return int(np.prod(shape))


class Reshape(Module):
    def __init__(self, shape, showWarnings=True, name=None):
        super().__init__(name)
        self.registerBlueprint(locals())

        self.showWarnings = showWarnings
        self.movesData = self.movesGrad = True

        self.shape = tuple(shape)
        self.inshape = None

        self.copyIdx = tuple(axis for axis, extent in enumerate(shape) if extent == 0)

    def copyAxis(self, shape, mask):
        """Substitute input extents for the 0-marked axes (-1 passes through)."""
        return tuple(mask[axis] if axis in self.copyIdx else extent for axis, extent in enumerate(shape))

    def _validate(self, inshape):
        target = self.copyAxis(self.shape, inshape)
        known = [extent for extent in target if extent != -1]

        consistent = (_volume(inshape) % _volume(known) == 0) if -1 in target else \
            (_volume(inshape) == _volume(target))

        if not consistent:
            raise ModuleError("Data shape %s is inconsistent with reshape %s" % (inshape, target))

        return target

    def updateData(self, data):
        self.inshape = tuple(data.shape)
        self.data = data.reshape(self.copyAxis(self.shape, self.inshape))

        if self.showWarnings and self.data.shape[0] != self.inshape[0]:
            Config.getLogger().info(
                "Warning: %s changed data batch axis size (was given %s, reshaped to %s)",
                self, tuple(data.shape), tuple(self.data.shape)
            )

    def updateGrad(self, grad):
        self.grad = grad.reshape(self.inshape)

    def checkDataShape(self, shape):
        self._validate(shape)

    def checkGradShape(self, shape):
        if _volume(shape) != _volume(self.inshape):
            raise ModuleError("Grad shape %s is inconsistent with reshape %s" % (shape, self.inshape))

    def dataShapeFrom(self, shape):
        target = self.copyAxis(self.shape, shape)

        if -1 not in target:
            return target

        hole = target.index(-1)
        inferred = _volume(shape) // _volume(target[:hole] + target[hole + 1:])

        return target[:hole] + (inferred, ) + target[hole + 1:]

    def gradShapeFrom(self, shape):
        return self.inshape

    def calcMode(self, T):
        self.calctype = self.requireSupportedDtype(T)
