"""2-D pooling base (counterpart of ``puzzlelib_tpu/modules/pool2d.py``)."""

from puzzlelib_tpu_torch.modules.module import ModuleError, Module


def _outExtent(inExtent, size, pad, stride):
    return (inExtent + 2 * pad - size) // stride + 1


def _inExtent(outExtent, size, pad, stride):
    return (outExtent - 1) * stride + size - 2 * pad


class Pool2D(Module):
    def __init__(self, size=2, stride=2, pad=0, name=None):
        super().__init__(name)

        self.gradUsesOutData = True

        self.size = self.repeat(size, 2)
        self.stride = self.repeat(stride, 2)
        self.pad = self.repeat(pad, 2)

        self.workspace = None

    def _window(self):
        """Per-axis (size, pad, stride) triples in (h, w) order."""
        return tuple(zip(self.size, self.pad, self.stride))

    def dataShapeFrom(self, shape):
        batchsize, maps = shape[:2]
        hgeom, wgeom = self._window()

        return batchsize, maps, _outExtent(shape[2], *hgeom), _outExtent(shape[3], *wgeom)

    def gradShapeFrom(self, shape):
        batchsize, maps = shape[:2]
        hgeom, wgeom = self._window()

        return batchsize, maps, _inExtent(shape[2], *hgeom), _inExtent(shape[3], *wgeom)

    def checkDataShape(self, shape):
        if len(shape) != 4:
            raise ModuleError("Data must be 4d tensor")

        for extent, (size, pad, _), axis in zip(shape[2:], self._window(), ("height", "width")):
            padded = extent + 2 * pad
            if padded < size:
                raise ModuleError("Data maps %s is too small (got %d, expected at least %d)" %
                                  (axis, padded, size))

    def checkGradShape(self, shape):
        if len(shape) != 4:
            raise ModuleError("Grad must be 4d tensor")

    def reset(self):
        super().reset()
        self.workspace = None

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
