"""Spatial transformer (counterpart of ``puzzlelib_tpu/modules/spatialtf.py``):
the input is the pair (data (N, C, H, W), transform (N, 2, 3)); data is
sampled bilinearly on the affine grid of each transform (``ops/spatialtf.py``),
to the maps ``shape[-2:]`` when ``shape`` is given, else to data's own.
In train mode the forward keeps its grid, which the backward reads again;
the backward gives the gradients of both inputs.  f32 only, as in the
reference."""

from puzzlelib_tpu_torch.backend.dnn import spatialTf, spatialTfBackward
from puzzlelib_tpu_torch.modules.module import ModuleError, Module


class SpatialTf(Module):
    def __init__(self, shape=None, name=None):
        super().__init__(name)
        self.registerBlueprint(locals())

        self.shape = shape
        self.grid = None

    def updateData(self, data):
        images, transform = data

        if self.training:
            self.data, self.grid = spatialTf(images, transform, outshape=self.shape, getGrid=True)
        else:
            self.data = spatialTf(images, transform, outshape=self.shape, getGrid=False)

    def updateGrad(self, grad):
        self.grad = list(spatialTfBackward(grad, self.inData[0], self.grid))

    def checkDataShape(self, shapes):
        dshape, tshape = shapes

        if tshape[1:] != (2, 3) or len(tshape) != 3:
            raise ModuleError("Bad transform shape (%s was given)" % (tshape, ))

        if len(dshape) != 4:
            raise ModuleError("Data must be 4d tensor")

        if dshape[0] != tshape[0]:
            raise ModuleError("Inconsistency in transform and data batch size (%d in transform vs %d in data)" %
                              (tshape[0], dshape[0]))

    def checkGradShape(self, shape):
        if len(shape) != 4:
            raise ModuleError("Grad must be 4d tensor")

        expected = tuple(self.shape) if self.shape is not None else tuple(self.inData[0].shape)
        given = tuple(shape[1:]) if self.shape is not None else tuple(shape)

        if given != expected:
            raise ModuleError("Bad grad shape (was given %s, expected %s)" % (given, expected))

    def dataShapeFrom(self, shapes):
        dshape = tuple(shapes[0])
        return dshape if self.shape is None else (dshape[0], ) + tuple(self.shape)

    def gradShapeFrom(self, shape):
        batch = shape[0]
        return [(batch, ) + tuple(self.inData[0].shape[1:]), (batch, 2, 3)]

    def reset(self):
        super().reset()
        self.grid = None
