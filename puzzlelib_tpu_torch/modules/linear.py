"""Fully-connected layer (counterpart of ``puzzlelib_tpu/modules/linear.py``).
The untransposed forward product is the one that ``Blas.mulMatrixOnMatrix``
sends to the GEMM kernel K1; the backward's products are transposed, and the
parameter gradients accumulate through ``beta``, so they go to the library
product, as in the reference.  ``optimizeForShape`` races K1 against cuBLAS at
the forward product's shape (``ops.hopper.matmul.tuneDispatch``), which
``Config.gemmAlgo = "auto"`` then reads.

In a tensor-parallel fused step (``fusedctx.modelBlocks``) the layer
computes with this rank's block of the output features (W's columns, its
rows when transposed, and b's entries): the forward gathers the output
features from the model group, the backward sums the partial input
gradient over it and writes this rank's block of the parameter
gradients."""

from puzzlelib_tpu_torch import fusedctx
from puzzlelib_tpu_torch.backend import blas as Blas
from puzzlelib_tpu_torch.backend.device import getDevice
from puzzlelib_tpu_torch.backend.kernels import matvec as MatVec
from puzzlelib_tpu_torch.variable import Variable
from puzzlelib_tpu_torch.modules.module import ModuleError, Module
from puzzlelib_tpu_torch.ops.hopper import matmul as _hopper


class Linear(Module):
    def __init__(self, insize, outsize, wscale=1.0, useBias=True, initscheme=None, name=None,
                 empty=False, transpose=False):
        super().__init__(name)
        self.registerBlueprint(locals())

        self.transpose = transpose
        self.useBias = useBias

        self.W = None
        self.b = None

        if empty:
            return

        Wshape, bshape = ((outsize, insize), (insize, )) if transpose else ((insize, outsize), (outsize, ))
        W = self.createTensorWithScheme(initscheme, Wshape, wscale, factorShape=Wshape)

        self.setVar("W", Variable(self.paramTensor(W, Wshape)))

        if useBias:
            self.setVar("b", Variable(self.paramTensor(None, bshape).zero_()))

    @property
    def _featureDim(self):
        """W's dim of the output features."""
        return 0 if self.transpose else 1

    def updateData(self, data):
        blocks = fusedctx.modelBlocks(self)
        self.data = Blas.mulMatrixOnMatrix(data, blocks.take(self.W, self._featureDim), transpB=self.transpose)

        if self.useBias:
            MatVec.addVecToMat(blocks.take(self.b, 0), self.data, axis=1, out=self.data)

        self.data = blocks.gather(self.data, 1)

    def updateGrad(self, grad):
        blocks = fusedctx.modelBlocks(self)
        self.grad = blocks.sum(Blas.mulMatrixOnMatrix(blocks.take(grad, 1), blocks.take(self.W, self._featureDim),
                                                      transpB=not self.transpose))

    def accGradParams(self, grad, scale=1.0, momentum=0.0):
        blocks = fusedctx.modelBlocks(self)
        grad, Wgrad = blocks.take(grad, 1), blocks.view(self.vars["W"].grad, self._featureDim)

        if not self.transpose:
            Blas.mulMatrixOnMatrix(self.inData, grad, out=Wgrad, transpA=True, alpha=scale, beta=momentum)
        else:
            Blas.mulMatrixOnMatrix(grad, self.inData, out=Wgrad, transpA=True, alpha=scale, beta=momentum)

        if self.useBias:
            Blas.sumOnMatrix(grad, out=blocks.view(self.vars["b"].grad, 0), alpha=scale, beta=momentum)

    def optimizeForShape(self, shape, memlimit=None):
        """Race the forward product's K1 against cuBLAS at ``shape`` and
        record the faster (the reference's cuDNN algo-search hook).  Nothing
        on the CPU, for a transposed Linear (its product never goes to K1)
        or where ``shape[1]`` is not the input width."""
        if getDevice().type != "cuda" or self.transpose:
            return

        insize, outsize = self.W.shape
        if shape[1] != insize:
            return

        _hopper.tuneDispatch(shape[0], outsize, insize, dtype=self.calctype)

    def dataShapeFrom(self, shape):
        return (shape[0], self.W.shape[1]) if not self.transpose else (shape[0], self.W.shape[0])

    def gradShapeFrom(self, shape):
        return (shape[0], self.W.shape[0]) if not self.transpose else (shape[0], self.W.shape[1])

    def checkGradShape(self, shape):
        if len(shape) != 2:
            raise ModuleError("Grad must be 2d matrix")

        size = self.W.shape[1] if not self.transpose else self.W.shape[0]
        if shape[1] != size:
            raise ModuleError("Expected %d grad dimensions, %d were given" % (size, shape[1]))

    def checkDataShape(self, shape):
        if len(shape) != 2:
            raise ModuleError("Data must be 2d matrix")

        size = self.W.shape[0] if not self.transpose else self.W.shape[1]
        if shape[1] != size:
            raise ModuleError("Expected %d data dimensions, %d were given" % (size, shape[1]))

    def calcMode(self, T):
        self.castVarsTo(self.requireSupportedDtype(T))
