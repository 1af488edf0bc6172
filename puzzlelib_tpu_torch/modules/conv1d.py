"""1-d convolution module (counterpart of ``puzzlelib_tpu/modules/conv1d.py``)
on ``ConvND``: data (N, C, T), weights (outmaps, inmaps // groups, size).
No hand kernel takes a 1-d conv, as no Pallas kernel does in the JAX
package: the three directions go to ``torch.nn.functional.conv1d``,
``conv_transpose1d`` and ``torch.nn.grad.conv1d_weight`` (cuDNN on the
card, TF32 off while ``Config.matmulPrecision`` is "highest")."""

from puzzlelib_tpu_torch.modules.module import ModuleError
from puzzlelib_tpu_torch.modules.convnd import ConvND


class Conv1D(ConvND):
    def __init__(self, inmaps, outmaps, size, stride=1, pad=0, dilation=1, wscale=1.0, useBias=True,
                 name=None, initscheme=None, empty=False, groups=1):
        super().__init__(
            1, inmaps, outmaps, size, stride, pad, dilation, wscale, useBias, name, initscheme, empty, groups
        )

    def checkDataShape(self, shape):
        if len(shape) != 3:
            raise ModuleError("Data must be 3d tensor")

        if shape[1] != self.W.shape[1] * self.groups:
            raise ModuleError("Data has %d maps (expected: %d)" % (shape[1], self.W.shape[1] * self.groups))

    def dataShapeFrom(self, shape):
        batchsize, inmaps, insize = shape
        outmaps, _, fsize = self.W.shape

        (pad, ), (dilation, ), (stride, ) = self.pad, self.dilation, self.stride
        outsize = (insize + 2 * pad - dilation * (fsize - 1) - 1) // stride + 1

        return batchsize, outmaps, outsize

    def checkGradShape(self, shape):
        if len(shape) != 3:
            raise ModuleError("Grad must be 3d tensor")

        if shape[1] != self.W.shape[0]:
            raise ModuleError("Grad has %d maps (expected: %d)" % (shape[1], self.W.shape[0]))

    def gradShapeFrom(self, shape):
        batchsize, outmaps, outsize = shape
        _, inmaps, fsize = self.W.shape

        (pad, ), (dilation, ), (stride, ) = self.pad, self.dilation, self.stride

        inmaps *= self.groups
        insize = (outsize - 1) * stride + dilation * (fsize - 1) - 2 * pad + 1

        return batchsize, inmaps, insize
