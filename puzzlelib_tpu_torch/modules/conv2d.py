"""2-D convolution module (counterpart of ``puzzlelib_tpu/modules/conv2d.py``)."""

from puzzlelib_tpu_torch.modules.module import ModuleError
from puzzlelib_tpu_torch.modules.convnd import ConvND


class Conv2D(ConvND):
    def __init__(self, inmaps, outmaps, size, stride=1, pad=0, dilation=1, wscale=1.0, useBias=True,
                 name=None, initscheme=None, empty=False, groups=1):
        super().__init__(
            2, inmaps, outmaps, size, stride, pad, dilation, wscale, useBias, name, initscheme, empty, groups
        )
        self.registerBlueprint(locals())

    def checkDataShape(self, shape):
        if len(shape) != 4:
            raise ModuleError("Data must be 4d tensor")

        _, inmaps, inh, inw = shape
        _, _, fh, fw = self.W.shape

        hpad, wpad = self.pad
        hdilation, wdilation = self.dilation

        if inmaps != self.W.shape[1] * self.groups:
            raise ModuleError("Data has %d maps (expected: %d)" % (inmaps, self.W.shape[1] * self.groups))

        exth, extw = inh + 2 * hpad, inw + 2 * wpad
        extfh, extfw = hdilation * (fh - 1) + 1, wdilation * (fw - 1) + 1

        if exth < extfh:
            raise ModuleError("Data maps height is too small (got %d, expected at least %d)" % (exth, extfh))

        if extw < extfw:
            raise ModuleError("Data maps width is too small (got %d, expected at least %d)" % (extw, extfw))

    def checkGradShape(self, shape):
        if len(shape) != 4:
            raise ModuleError("Grad must be 4d tensor")

        if shape[1] != self.W.shape[0]:
            raise ModuleError("Grad has %d maps (expected: %d)" % (shape[1], self.W.shape[0]))

    def dataShapeFrom(self, shape):
        batchsize, inmaps, inh, inw = shape
        outmaps, _, fh, fw = self.W.shape

        hpad, wpad = self.pad
        hdilation, wdilation = self.dilation
        hstride, wstride = self.stride

        outh = (inh + 2 * hpad - hdilation * (fh - 1) - 1) // hstride + 1
        outw = (inw + 2 * wpad - wdilation * (fw - 1) - 1) // wstride + 1

        return batchsize, outmaps, outh, outw

    def gradShapeFrom(self, shape):
        batchsize, outmaps, outh, outw = shape
        _, inmaps, fh, fw = self.W.shape

        hpad, wpad = self.pad
        hdilation, wdilation = self.dilation
        hstride, wstride = self.stride

        inmaps *= self.groups
        inh = (outh - 1) * hstride + hdilation * (fh - 1) - 2 * hpad + 1
        inw = (outw - 1) * wstride + wdilation * (fw - 1) - 2 * wpad + 1

        return batchsize, inmaps, inh, inw
