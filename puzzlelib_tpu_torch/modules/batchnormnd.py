"""N-dimensional batch normalization (counterpart of
``puzzlelib_tpu/modules/batchnormnd.py``): per-map statistics over the batch
and the spatial dims, and running mean and variance blended with a decaying
factor, ``max(initFactor / numOfProps, minFactor)``.

The running mean and variance are the module's attributes (``setAttr``),
written in place and never rebound, so a fused step's CUDA graph replays
their updates at the same addresses.  Inside a fused step the factor is
``max(initFactor / t, minFactor)`` of the step counter ``t``, a 0-d tensor
on the device (``fusedctx.stepOr``), so every replay blends with its own
step's factor.  ``calcMode`` only sets the calculation type: the scale,
bias and running stats stay f32 in a bf16 net, as in the reference, and an
optimizer in global state keeps them in its f32 flat buffer.
"""

import numpy as np
import torch

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch import fusedctx
from puzzlelib_tpu_torch.backend import gpuarray
from puzzlelib_tpu_torch.backend.dnn import BatchNormMode, batchNormNd, batchNormNdBackward
from puzzlelib_tpu_torch.variable import Variable
from puzzlelib_tpu_torch.modules.module import ModuleError, Module


def initNormState(mod, shape, sscale):
    """The reference's start state of a batch norm of stat ``shape``: the
    scale jittered around 1 by ``sscale`` when affine (exactly 1 otherwise),
    a zero bias, running stats (0, 1), all f32."""
    jitter = sscale if mod.affine else 0.0
    initScale = np.random.normal(1.0, jitter, shape).astype(np.float32)

    mod.setVar("scale", Variable(gpuarray.to_gpu(initScale)))
    mod.setVar("bias", Variable(gpuarray.zeros(shape, dtype=np.float32)))

    mod.setAttr("mean", gpuarray.zeros(shape, dtype=np.float32))
    mod.setAttr("var", gpuarray.to_gpu(np.ones(shape, dtype=np.float32)))


def blendFactor(mod):
    """The running stats' blend weight, initFactor / step floored at
    minFactor: the module's own count of train forwards, or inside a fused
    step the step counter, as a 0-d device tensor."""
    if fusedctx.active():
        return torch.clamp_min(mod.initFactor / fusedctx.stepOr(1), mod.minFactor)

    mod.numOfProps += 1
    return max(mod.initFactor / mod.numOfProps, mod.minFactor)


class BatchNormND(Module):
    mode = BatchNormMode.spatial

    def __init__(self, nd, maps, epsilon=1e-5, initFactor=1.0, minFactor=0.1, sscale=0.01, affine=True, name=None,
                 empty=False, inplace=False):
        super().__init__(name)

        self.inplace = inplace
        if inplace and Config.showWarnings:
            Config.getLogger().info("Warning: %s is using inplace flag", self)

        self.maps, self.epsilon = maps, epsilon
        self.initFactor, self.minFactor = initFactor, minFactor
        self.numOfProps = 0
        self.affine = affine

        self.scale = self.bias = self.mean = self.var = None
        self.savemean = self.saveinvvar = None
        self.scalegrad = self.biasgrad = None

        if not empty:
            initNormState(self, (1, maps) + self.repeat(1, nd), sscale)

    def _view(self, tensor):
        """The tensor the norm runs on (the per-activation norm's 4d view)."""
        return tensor

    def updateData(self, data):
        view = self._view(data)

        if not self.training:
            out = batchNormNd(view, self.scale, self.bias, self.mean, self.var, self.epsilon, 0, True, self.mode,
                              out=view if self.inplace else None)
        else:
            if self.inplace:
                raise ModuleError("%s: using inplace flag in train mode is prohibited" % self)

            out, self.savemean, self.saveinvvar = batchNormNd(
                view, self.scale, self.bias, self.mean, self.var, self.epsilon, blendFactor(self), False, self.mode
            )

        self.data = out.reshape(data.shape)

    def updateGrad(self, grad):
        ingrad, dscale, dbias = batchNormNdBackward(
            self._view(self.inData), self._view(grad), self.scale, self.savemean, self.saveinvvar, self.epsilon,
            self.mode
        )

        self.grad = ingrad.reshape(grad.shape)
        if self.affine:
            self.scalegrad, self.biasgrad = dscale, dbias

    def accGradParams(self, grad, scale=1.0, momentum=0.0):
        if not self.affine:
            return

        self.foldParamGrad("scale", self.scalegrad, scale, momentum)
        self.foldParamGrad("bias", self.biasgrad, scale, momentum)

    def dataShapeFrom(self, shape):
        return shape

    gradShapeFrom = dataShapeFrom

    def checkMapsShape(self, shape, ndim, what):
        if len(shape) != ndim:
            raise ModuleError("%s must be %dd tensor" % (what, ndim))

        if shape[1] != self.maps:
            raise ModuleError("%s has %d maps (expected: %d)" % (what, shape[1], self.maps))

    def reset(self):
        super().reset()

        self.savemean = self.saveinvvar = None
        if self.affine:
            self.scalegrad = self.biasgrad = None

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
