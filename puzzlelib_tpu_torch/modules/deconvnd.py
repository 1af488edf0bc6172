"""N-d transposed convolution module (counterpart of
``puzzlelib_tpu/modules/deconvnd.py``): grouped, with ``postpad`` trimming
the output's high side back in, weights laid out (inmaps, outmaps // groups,
*size) and drawn with ``factorTranspose``, so one ``np.random.seed`` gives
both packages the same weights.  The cuDNN-style algo fields are kept as the
reference keeps them; ``Config.convAlgo`` chooses between the hand kernels
(K2 forward and bwd-data, K3 bwd-filter, where ``winograd.applicable`` takes
the stride-1 3x3 deconv) and the library.  Under "auto" its directions read
the conv table's entries of the kernels they run (its forward a bwd-data
key, its bwd-data a forward key, ``ops.conv``); its ``optimizeForShape``
times the configured route and races nothing, as the reference's does not.

With ``groups > 1`` the bias has ``outmaps // groups`` maps, as in the
reference, so the forward of a grouped deconv with a bias fails in both
packages; it is kept so."""

from puzzlelib_tpu_torch.backend.dnn import ConvBwdDataAlgo, ConvBwdFilterAlgo, ConvFwdAlgo
from puzzlelib_tpu_torch.backend.dnn import convNdbenchmark, deconvNd, deconvNdBackwardData, deconvNdBackwardParams
from puzzlelib_tpu_torch.variable import Variable
from puzzlelib_tpu_torch.modules.module import ModuleError, Module


class DeconvND(Module):
    def __init__(self, nd, inmaps, outmaps, size, stride=1, pad=0, dilation=1, postpad=0, wscale=1.0, useBias=True,
                 name=None, initscheme=None, empty=False, groups=1):
        super().__init__(name)

        self.stride, self.pad = self.repeat(stride, nd), self.repeat(pad, nd)
        self.dilation, self.postpad = self.repeat(dilation, nd), self.repeat(postpad, nd)
        self.useBias, self.groups = useBias, groups

        if any(pp >= max(s, d) for pp, s, d in zip(self.postpad, self.stride, self.dilation)):
            raise ModuleError("Postpad must be smaller than stride and dilation")

        if inmaps % groups or outmaps % groups:
            raise ModuleError(
                "Number of input and output maps must be divisible by number of groups "
                "(%d inmaps, %d outmaps, %d groups)" % (inmaps, outmaps, groups)
            )

        self.fwdAlgo = ConvFwdAlgo.auto
        self.bwdFilterAlgo = ConvBwdFilterAlgo.auto
        self.bwdDataAlgo = ConvBwdDataAlgo.auto

        self.W, self.b = None, None

        if not empty:
            self._initParams(inmaps, outmaps // groups, self.repeat(size, nd), initscheme, wscale, nd)

    def _initParams(self, inmaps, outmapsPerGroup, window, initscheme, wscale, nd):
        Wshape = (inmaps, outmapsPerGroup) + window
        W = self.createTensorWithScheme(initscheme, Wshape, wscale, factorTranspose=True)

        self.setVar("W", Variable(self.paramTensor(W, Wshape)))

        if self.useBias:
            self.setVar("b", Variable(self.paramTensor(None, (1, outmapsPerGroup) + (1, ) * nd).zero_()))

    def optimizeForShape(self, shape, memlimit=None):
        """Time the deconv's three directions at ``shape`` on the
        configured route (``convNdbenchmark``); no race."""
        outshape = self.dataShapeFrom(shape)
        convNdbenchmark(outshape, self.W.shape, self.stride, self.pad, self.dilation, self.groups, transpose=True,
                        dtype=self.calctype)

    def updateData(self, data):
        self.data = deconvNd(data, self.W, self.b, stride=self.stride, pad=self.pad, dilation=self.dilation,
                             postpad=self.postpad, groups=self.groups)

    def updateGrad(self, grad):
        self.grad = deconvNdBackwardData(grad, self.W, data=self.inData, stride=self.stride, pad=self.pad,
                                         dilation=self.dilation, groups=self.groups)

    def accGradParams(self, grad, scale=1.0, momentum=0.0):
        bgrad = self.vars["b"].grad if self.b is not None else None
        deconvNdBackwardParams(self.inData, grad, self.W, self.b, stride=self.stride, pad=self.pad,
                               dilation=self.dilation, groups=self.groups, wgrad=self.vars["W"].grad,
                               bgrad=bgrad, scale=scale, momentum=momentum)

    def dataShapeFrom(self, shape):
        raise NotImplementedError()

    def gradShapeFrom(self, shape):
        raise NotImplementedError()

    def calcMode(self, T):
        self.castVarsTo(self.requireSupportedDtype(T))
