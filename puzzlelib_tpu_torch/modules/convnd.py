"""N-d convolution module (counterpart of
``puzzlelib_tpu/modules/convnd.py``).  The reference's cuDNN-style algo slots
are not carried: ``Config.convAlgo`` chooses between the hand kernels and the
library, under "auto" from the race that ``optimizeForShape`` runs.

In a tensor-parallel fused step (``fusedctx.modelBlocks``) the conv
computes with this rank's block of the output maps (W's and b's): the
forward gathers the maps from the model group, the backward sums the
partial input gradient over it and writes this rank's block of the
parameter gradients."""

from puzzlelib_tpu_torch import fusedctx
from puzzlelib_tpu_torch.backend.dnn import (
    convKernelLayout, convNd, convNdBackwardData, convNdBackwardParams, convNdbenchmark
)
from puzzlelib_tpu_torch.variable import Variable
from puzzlelib_tpu_torch.modules.module import ModuleError, Module


class ConvND(Module):
    def __init__(self, nd, inmaps, outmaps, size, stride=1, pad=0, dilation=1, wscale=1.0, useBias=True,
                 name=None, initscheme=None, empty=False, groups=1):
        super().__init__(name)

        self.stride, self.pad = self.repeat(stride, nd), self.repeat(pad, nd)
        self.dilation = self.repeat(dilation, nd)
        self.useBias, self.groups = useBias, groups

        if inmaps % groups or outmaps % groups:
            raise ModuleError(
                "Number of input and output maps must be divisible by number of groups "
                "(%d inmaps, %d outmaps, %d groups)" % (inmaps, outmaps, groups)
            )

        self.W, self.b = None, None

        if not empty:
            self._initParams(outmaps, inmaps // groups, self.repeat(size, nd), initscheme, wscale, nd)

    def _initParams(self, outmaps, inmapsPerGroup, window, initscheme, wscale, nd):
        Wshape = (outmaps, inmapsPerGroup) + window
        W = self.createTensorWithScheme(initscheme, Wshape, wscale)

        self.setVar("W", Variable(self.paramTensor(W, Wshape)))

        if self.useBias:
            self.setVar("b", Variable(self.paramTensor(None, (1, outmaps) + (1, ) * nd).zero_()))

    def optimizeForShape(self, shape, memlimit=None):
        """Race the hand kernels that take the conv at ``shape`` against
        the library, each direction on its own, and record the faster for
        ``Config.convAlgo = "auto"`` (nothing on the CPU); then time the
        conv's forward, bwd-filter and bwd-data on the configured route, as
        the reference's does (``convNdbenchmark``)."""
        convNdbenchmark(shape, self.W.shape, self.stride, self.pad, self.dilation, self.groups, transpose=False,
                        dtype=self.calctype)

    def _blocks(self):
        """(this rank's blocks, its W, its b) in a tensor-parallel step;
        the whole layer's otherwise."""
        blocks = fusedctx.modelBlocks(self)
        return blocks, blocks.take(self.W, 0), blocks.take(self.b, 1) if self.b is not None else None

    def updateData(self, data):
        blocks, W, b = self._blocks()

        # kept as inData in the kernels' layout: the backward reads it again
        self.inData = data = convKernelLayout(data, W, stride=self.stride, pad=self.pad,
                                              dilation=self.dilation, groups=self.groups)
        self.data = blocks.gather(convNd(data, W, b, stride=self.stride, pad=self.pad, dilation=self.dilation,
                                         groups=self.groups), 1)

    def updateGrad(self, grad):
        blocks, W, _ = self._blocks()
        self.grad = blocks.sum(convNdBackwardData(blocks.take(grad, 1), W, data=self.inData, stride=self.stride,
                                                  pad=self.pad, dilation=self.dilation, groups=self.groups))

    def accGradParams(self, grad, scale=1.0, momentum=0.0):
        blocks, W, b = self._blocks()
        bgrad = blocks.view(self.vars["b"].grad, 1) if self.b is not None else None
        convNdBackwardParams(self.inData, blocks.take(grad, 1), W, b, stride=self.stride, pad=self.pad,
                             dilation=self.dilation, groups=self.groups, wgrad=blocks.view(self.vars["W"].grad, 0),
                             bgrad=bgrad, scale=scale, momentum=momentum)

    def dataShapeFrom(self, shape):
        raise NotImplementedError()

    def gradShapeFrom(self, shape):
        raise NotImplementedError()

    def calcMode(self, T):
        self.castVarsTo(self.requireSupportedDtype(T))
