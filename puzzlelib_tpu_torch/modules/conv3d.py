"""3-d convolution module (counterpart of ``puzzlelib_tpu/modules/conv3d.py``)
on ``ConvND``: data (N, C, D, H, W), weights (outmaps, inmaps // groups, kd,
kh, kw).  No hand kernel takes a 3-d conv, as no Pallas kernel does in the
JAX package: the three directions go to ``torch.nn.functional.conv3d``,
``conv_transpose3d`` (or the plain conv of the rotated filter at stride 1)
and ``torch.nn.grad.conv3d_weight`` (``ops/conv.py``)."""

from puzzlelib_tpu_torch.modules.module import ModuleError
from puzzlelib_tpu_torch.modules.convnd import ConvND


class Conv3D(ConvND):
    def __init__(self, inmaps, outmaps, size, stride=1, pad=0, dilation=1, wscale=1.0, useBias=True,
                 name=None, initscheme=None, empty=False, groups=1):
        super().__init__(
            3, inmaps, outmaps, size, stride, pad, dilation, wscale, useBias, name, initscheme, empty, groups
        )

    def checkDataShape(self, shape):
        if len(shape) != 5:
            raise ModuleError("Data must be 5d tensor")

        if shape[1] != self.W.shape[1] * self.groups:
            raise ModuleError("Data has %d maps (expected: %d)" % (shape[1], self.W.shape[1] * self.groups))

    def dataShapeFrom(self, shape):
        batchsize = shape[0]
        outspatial = tuple(
            (shape[2 + i] + 2 * self.pad[i] - self.dilation[i] * (self.W.shape[2 + i] - 1) - 1) // self.stride[i] + 1
            for i in range(3)
        )

        return (batchsize, self.W.shape[0]) + outspatial

    def checkGradShape(self, shape):
        if len(shape) != 5:
            raise ModuleError("Grad must be 5d tensor")

        if shape[1] != self.W.shape[0]:
            raise ModuleError("Grad has %d maps (expected: %d)" % (shape[1], self.W.shape[0]))

    def gradShapeFrom(self, shape):
        batchsize = shape[0]
        inspatial = tuple(
            (shape[2 + i] - 1) * self.stride[i] + self.dilation[i] * (self.W.shape[2 + i] - 1) - 2 * self.pad[i] + 1
            for i in range(3)
        )

        return (batchsize, self.W.shape[1] * self.groups) + inspatial
