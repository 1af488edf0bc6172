"""3-d transposed convolution module (counterpart of
``puzzlelib_tpu/modules/deconv3d.py``) on ``DeconvND``: data (N, C, D, H,
W), weights (inmaps, outmaps // groups, kd, kh, kw); the library's
``conv_transpose3d``, ``conv3d`` and ``conv3d_weight`` (``ops/conv.py``)."""

from puzzlelib_tpu_torch.modules.module import ModuleError
from puzzlelib_tpu_torch.modules.deconvnd import DeconvND


class Deconv3D(DeconvND):
    def __init__(self, inmaps, outmaps, size, stride=1, pad=0, dilation=1, postpad=0, wscale=1.0, useBias=True,
                 name=None, initscheme=None, empty=False, groups=1):
        super().__init__(
            3, inmaps, outmaps, size, stride, pad, dilation, postpad, wscale, useBias, name, initscheme, empty, groups
        )

    def checkDataShape(self, shape):
        if len(shape) != 5:
            raise ModuleError("Data must be 5d tensor")

        if shape[1] != self.W.shape[0]:
            raise ModuleError("Data has %d maps (expected: %d)" % (shape[1], self.W.shape[0]))

    def dataShapeFrom(self, shape):
        outspatial = tuple(
            (shape[2 + i] - 1) * self.stride[i] + self.dilation[i] * (self.W.shape[2 + i] - 1)
            - 2 * self.pad[i] + 1 + self.postpad[i]
            for i in range(3)
        )

        return (shape[0], self.W.shape[1] * self.groups) + outspatial

    def checkGradShape(self, shape):
        if len(shape) != 5:
            raise ModuleError("Grad must be 5d tensor")

        if shape[1] != self.W.shape[1] * self.groups:
            raise ModuleError("Grad has %d maps (expected: %d)" % (shape[1], self.W.shape[1] * self.groups))

    def gradShapeFrom(self, shape):
        inspatial = tuple(
            (shape[2 + i] + 2 * self.pad[i] - self.dilation[i] * (self.W.shape[2 + i] - 1) - 1) // self.stride[i] + 1
            for i in range(3)
        )

        return (shape[0], self.W.shape[0]) + inspatial
