"""Recurrent module: relu / tanh / LSTM / GRU, one or two directions, several
levels (counterpart of ``puzzlelib_tpu/modules/rnn.py``; the engine is
``backend/rnn.py``).

Data is (T, B, insize).  With ``getSequences`` the output is every step's
hidden state (T, B, H * dirs); without it, one direction gives the last
step's (B, H), two give the list [the forward direction's last step, the
backward direction's first step], (B, H) each.  The backward takes the
matching gradient, spreads it over a zero (T, B, H * dirs) gradient as the
reference does (``_buildFullGrad``) and runs ``backwardRnn`` once for the
input's and the weights' gradients; ``accGradParams`` folds the cached
weight gradient, or takes one of its own where ``updateGrad`` did not run.

The constructor takes the reference's seed draw (``np.random.randint``)
and ``initParams`` its orthogonal draws (``np.random.normal`` and an SVD) in
the reference's order, so one ``np.random.seed`` gives both packages the
same flat weight.  The weights stay f32, as the reference's, whose
``calcMode`` takes f32 only.  ``rng`` (``rng.globalRng``) draws the dropout
masks between levels, so a fused step registers its generator.
"""

from enum import Enum

import numpy as np
import torch

from puzzlelib_tpu_torch.backend.dnn import RNNMode as BackendRNNMode, DirectionMode as BackendDirectionMode
from puzzlelib_tpu_torch.backend.dnn import acquireRnnParams, backwardRnn, createRnn, forwardRnn, updateRnnParams
from puzzlelib_tpu_torch.modules.module import ModuleError, Module
from puzzlelib_tpu_torch.variable import Variable


class RNNMode(str, Enum):
    relu = "relu"
    tanh = "tanh"
    lstm = "lstm"
    gru = "gru"


class DirectionMode(str, Enum):
    uni = "uni"
    bi = "bi"


class WeightModifier(str, Enum):
    orthogonal = "orthogonal"
    identity = "identity"


class RNN(Module):
    def __init__(self, insize, hsize, layers=1, mode="relu", direction="uni", dropout=0.0, getSequences=False,
                 initscheme=None, modifier="orthogonal", wscale=1.0, hintBatchSize=None, name=None):
        super().__init__(name)

        from puzzlelib_tpu_torch.rng import globalRng

        self.gradUsesOutData = True

        self.insize = insize
        self.hsize = hsize
        self.layers = layers
        self.mode = RNNMode(mode)
        self.direction = DirectionMode(direction)
        self.dropout = dropout
        self.getSequences = getSequences
        self.hintBatchSize = hintBatchSize
        self.rng = globalRng

        self.descRnn, W, params = createRnn(
            insize, hsize, layers, BackendRNNMode(self.mode.value), BackendDirectionMode(self.direction.value),
            dropout, seed=int(np.random.randint(1 << 31)), batchsize=hintBatchSize
        )
        self.descRnn.rng = self.rng

        self.W = None
        self.setVar("W", Variable(W))
        self.params = params

        self.initParams(initscheme, wscale, modifier)
        self.reserve, self.fulldata, self.dw, self.dwFrom = None, None, None, None

    def initParams(self, initscheme, wscale, modifier):
        modifier = WeightModifier(modifier)

        for key in sorted(self.params.keys()):
            for paramName, param in sorted(self.params[key].items()):
                if paramName.startswith("b"):
                    param.fill_(0.0)
                    continue

                if paramName.startswith("r"):
                    if modifier == WeightModifier.orthogonal:
                        a = np.random.normal(0.0, 1.0, param.shape)
                        u, _, v = np.linalg.svd(a, full_matrices=False)
                        W = u if u.shape == param.shape else v
                        W = W[:param.shape[0], :param.shape[1]].astype(np.float32)

                    elif modifier == WeightModifier.identity:
                        W = np.identity(param.shape[0], dtype=np.float32)

                    else:
                        raise NotImplementedError(modifier)
                else:
                    W = self.createTensorWithScheme(initscheme, param.shape, wscale)
                    if W is None:
                        continue

                param.copy_(torch.from_numpy(np.ascontiguousarray(W)))

        self.updateDeviceMemory()

    def updateDeviceMemory(self):
        updateRnnParams(self.descRnn, self.W, self.params)

    def setVar(self, name, var):
        if name == "W" and "params" in self.__dict__:
            _, self.params = acquireRnnParams(self.descRnn, var.data.detach())

        super().setVar(name, var)

    def updateData(self, data):
        if self.training:
            self.fulldata, self.reserve = forwardRnn(data, self.W, self.descRnn)
        else:
            self.fulldata = forwardRnn(data, self.W, self.descRnn, test=True)

        self.dw, self.dwFrom = None, None

        if self.direction == DirectionMode.uni:
            self.data = self.fulldata if self.getSequences else self.fulldata[-1]
        elif self.getSequences:
            self.data = self.fulldata
        else:
            self.data = [self.fulldata[-1][:, :self.hsize], self.fulldata[0][:, self.hsize:]]

    def _buildFullGrad(self, grad):
        if self.getSequences:
            return grad

        seqlen = self.fulldata.shape[0]

        if self.direction == DirectionMode.uni:
            fullgrad = torch.zeros((seqlen, ) + tuple(grad.shape), dtype=grad.dtype, device=grad.device)
            fullgrad[seqlen - 1] = grad

        else:
            fwdgrad, bwdgrad = grad
            fullgrad = torch.zeros((seqlen, fwdgrad.shape[0], 2 * self.hsize), dtype=fwdgrad.dtype,
                                   device=fwdgrad.device)
            fullgrad[0, :, bwdgrad.shape[1]:] = bwdgrad
            fullgrad[-1, :, :fwdgrad.shape[1]] = fwdgrad

        return fullgrad

    def updateGrad(self, grad):
        self.grad, self.dw = backwardRnn(self._buildFullGrad(grad), self.descRnn)
        self.dwFrom = grad

    def accGradParams(self, grad, scale=1.0, momentum=0.0):
        # updGrad=False on a net's first module skips updateGrad: take the
        # weights' gradient alone
        if self.dwFrom is not grad:
            _, self.dw = backwardRnn(self._buildFullGrad(grad), self.descRnn, withData=False)
            self.dwFrom = grad

        self.foldParamGrad("W", self.dw, scale, momentum)

    def checkDataShape(self, shape):
        if len(shape) != 3:
            raise ModuleError("Data must be 3d tensor")

        if shape[2] != self.insize:
            raise ModuleError("Data must have data size = %s (was given %s)" % (self.insize, shape[2]))

    def checkGradShape(self, shape):
        if self.getSequences:
            if len(shape) != 3:
                raise ModuleError("Grad must be 3d tensor")

        elif self.direction == DirectionMode.uni:
            if len(shape) != 2:
                raise ModuleError("Grad must be 2d matrix")

            if shape[-1] != self.hsize:
                raise ModuleError("Grad must have data size = %s (was given %s)" % (self.hsize, shape[-1]))

        else:
            fwdshape, bwdshape = shape

            if len(fwdshape) != 2 or len(bwdshape) != 2:
                raise ModuleError("Grads must be 2d matrices")

            if fwdshape[-1] != self.hsize or bwdshape[-1] != self.hsize:
                raise ModuleError("Grads must have data size = %s (was given %s and %s)" %
                                  (self.hsize, fwdshape[1], bwdshape[1]))

    def dataShapeFrom(self, shape):
        hsize = self.hsize if self.direction == DirectionMode.uni else 2 * self.hsize

        if self.getSequences:
            return tuple(shape[:2]) + (hsize, )

        return (shape[1], hsize) if self.direction == DirectionMode.uni \
            else [(shape[1], self.hsize), (shape[1], self.hsize)]

    def gradShapeFrom(self, shape):
        seqlen = self.inData.shape[0]

        if self.getSequences:
            batchsize = shape[1]
        else:
            batchsize = shape[0] if self.direction == DirectionMode.uni else shape[0][0]

        return seqlen, batchsize, self.insize

    def reset(self):
        super().reset()
        self.reserve, self.fulldata, self.dw, self.dwFrom = None, None, None, None

