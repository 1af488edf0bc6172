"""Depth concatenation of maps of different spatial extents, each centered
in the largest extent and padded with zeros (counterpart of
``puzzlelib_tpu/modules/depthconcat.py``; ``backend.memory.depthConcat``).
The backward cuts the gradient back into the inputs' pieces, views of it,
as ``Concat``'s does.  Unlike the reference, it takes the types
``calcMode`` allows."""

from puzzlelib_tpu_torch.backend import memory as Memory
from puzzlelib_tpu_torch.modules.module import ModuleError, Module


def _enclosingShape(shapes):
    """(batch, sum of depths, max h, max w) over the input map shapes."""
    return (shapes[0][0], sum(s[1] for s in shapes), max(s[2] for s in shapes), max(s[3] for s in shapes))


class DepthConcat(Module):
    def __init__(self, name=None):
        super().__init__(name)
        self.movesData = True

    def updateData(self, data):
        self.data = Memory.depthConcat(data)

    def updateGrad(self, grad):
        self.grad = Memory.depthSplit(grad, self.inData)

    def dataShapeFrom(self, shapes):
        return _enclosingShape(shapes)

    def gradShapeFrom(self, shape):
        return [tuple(data.shape) for data in self.inData]

    def checkDataShape(self, shapes):
        if not isinstance(shapes, list):
            raise ModuleError("Data must be list of tensors")

        for shape in shapes:
            if len(shape) != 4:
                raise ModuleError("Data must consist of 4d tensors")

            if shape[0] != shapes[0][0]:
                raise ModuleError("Inconsistency in batch size")

    def checkGradShape(self, shape):
        if len(shape) != 4:
            raise ModuleError("Grad must be 4d tensor")

        expected = _enclosingShape([tuple(data.shape) for data in self.inData])
        if shape != expected:
            raise ModuleError("Bad grad shape (%s given, %s expected)" % (shape, expected))

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
