"""2-D transposed convolution module (counterpart of
``puzzlelib_tpu/modules/deconv2d.py``)."""

from puzzlelib_tpu_torch.modules.module import ModuleError
from puzzlelib_tpu_torch.modules.deconvnd import DeconvND


class Deconv2D(DeconvND):
    def __init__(self, inmaps, outmaps, size, stride=1, pad=0, dilation=1, postpad=0, wscale=1.0, useBias=True,
                 name=None, initscheme=None, empty=False, groups=1):
        super().__init__(
            2, inmaps, outmaps, size, stride, pad, dilation, postpad, wscale, useBias, name, initscheme, empty, groups
        )

    def checkDataShape(self, shape):
        if len(shape) != 4:
            raise ModuleError("Data must be 4d tensor")

        if shape[1] != self.W.shape[0]:
            raise ModuleError("Data has %d maps (expected: %d)" % (shape[1], self.W.shape[0]))

    def dataShapeFrom(self, shape):
        batchsize, inmaps, inh, inw = shape
        _, outmaps, fh, fw = self.W.shape

        hpad, wpad = self.pad
        hpostpad, wpostpad = self.postpad
        hdilation, wdilation = self.dilation
        hstride, wstride = self.stride

        outmaps *= self.groups
        outh = (inh - 1) * hstride + hdilation * (fh - 1) - 2 * hpad + 1 + hpostpad
        outw = (inw - 1) * wstride + wdilation * (fw - 1) - 2 * wpad + 1 + wpostpad

        return batchsize, outmaps, outh, outw

    def checkGradShape(self, shape):
        if len(shape) != 4:
            raise ModuleError("Grad must be 4d tensor")

        if shape[1] != self.W.shape[1] * self.groups:
            raise ModuleError("Grad has %d maps (expected: %d)" % (shape[1], self.W.shape[1] * self.groups))

    def gradShapeFrom(self, shape):
        batchsize, outmaps, outh, outw = shape
        inmaps, _, fh, fw = self.W.shape

        hpad, wpad = self.pad
        hdilation, wdilation = self.dilation
        hstride, wstride = self.stride

        inh = (outh + 2 * hpad - hdilation * (fh - 1) - 1) // hstride + 1
        inw = (outw + 2 * wpad - wdilation * (fw - 1) - 1) // wstride + 1

        return batchsize, inmaps, inh, inw
