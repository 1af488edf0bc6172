"""1-d transposed convolution module (counterpart of
``puzzlelib_tpu/modules/deconv1d.py``) on ``DeconvND``: data (N, C, T),
weights (inmaps, outmaps // groups, size).  Its forward is the library's
``conv_transpose1d``, its bwd-data ``conv1d`` and its bwd-filter
``conv1d_weight`` with the roles of data and gradient swapped, on cuDNN's
deterministic algorithms (``ops/conv.py``)."""

from puzzlelib_tpu_torch.modules.module import ModuleError
from puzzlelib_tpu_torch.modules.deconvnd import DeconvND


class Deconv1D(DeconvND):
    def __init__(self, inmaps, outmaps, size, stride=1, pad=0, dilation=1, postpad=0, wscale=1.0, useBias=True,
                 name=None, initscheme=None, empty=False, groups=1):
        super().__init__(
            1, inmaps, outmaps, size, stride, pad, dilation, postpad, wscale, useBias, name, initscheme, empty, groups
        )
        self.registerBlueprint(locals())

    def checkDataShape(self, shape):
        if len(shape) != 3:
            raise ModuleError("Data must be 3d tensor")

        if shape[1] != self.W.shape[0]:
            raise ModuleError("Data has %d maps (expected: %d)" % (shape[1], self.W.shape[0]))

    def dataShapeFrom(self, shape):
        batchsize, _, insize = shape
        _, outmaps, fsize = self.W.shape

        (pad, ), (postpad, ) = self.pad, self.postpad
        (dilation, ), (stride, ) = self.dilation, self.stride

        outsize = (insize - 1) * stride + dilation * (fsize - 1) - 2 * pad + 1 + postpad
        return batchsize, outmaps * self.groups, outsize

    def checkGradShape(self, shape):
        if len(shape) != 3:
            raise ModuleError("Grad must be 3d tensor")

        if shape[1] != self.W.shape[1] * self.groups:
            raise ModuleError("Grad has %d maps (expected: %d)" % (shape[1], self.W.shape[1] * self.groups))

    def gradShapeFrom(self, shape):
        batchsize, _, outsize = shape
        inmaps, _, fsize = self.W.shape

        (pad, ), (dilation, ), (stride, ) = self.pad, self.dilation, self.stride
        insize = (outsize + 2 * pad - dilation * (fsize - 1) - 1) // stride + 1

        return batchsize, inmaps, insize
