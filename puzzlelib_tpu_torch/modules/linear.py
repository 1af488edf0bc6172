"""Fully-connected layer (counterpart of ``puzzlelib_tpu/modules/linear.py``).
The untransposed forward product is the one that ``Blas.mulMatrixOnMatrix``
sends to the GEMM kernel K1; the backward's products are transposed, and the
parameter gradients accumulate through ``beta``, so they go to the library
product, as in the reference.  ``optimizeForShape`` races K1 against cuBLAS at
the forward product's shape (``ops.hopper.matmul.tuneDispatch``), which
``Config.gemmAlgo = "auto"`` then reads."""

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

    def updateData(self, data):
        self.data = Blas.mulMatrixOnMatrix(data, self.W, transpB=self.transpose)

        if self.useBias:
            MatVec.addVecToMat(self.b, self.data, axis=1, out=self.data)

    def updateGrad(self, grad):
        self.grad = Blas.mulMatrixOnMatrix(grad, self.W, transpB=not self.transpose)

    def accGradParams(self, grad, scale=1.0, momentum=0.0):
        if not self.transpose:
            Blas.mulMatrixOnMatrix(self.inData, grad, out=self.vars["W"].grad, transpA=True,
                                   alpha=scale, beta=momentum)
        else:
            Blas.mulMatrixOnMatrix(grad, self.inData, out=self.vars["W"].grad, transpA=True,
                                   alpha=scale, beta=momentum)

        if self.useBias:
            Blas.sumOnMatrix(grad, out=self.vars["b"].grad, alpha=scale, beta=momentum)

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
