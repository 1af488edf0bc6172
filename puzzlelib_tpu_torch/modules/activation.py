"""Elementwise activation module (counterpart of
``puzzlelib_tpu/modules/activation.py``).  All seven activation names are
kept; relu, which the VGG slices run, is the one ported yet, and the others
raise at construction.  The ``slc`` slice option comes with them.  The
derivative is taken from the output (``gradUsesOutData``); an inplace module
writes its gradient over the incoming one."""

from enum import Enum

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.ops import elementwise as ew
from puzzlelib_tpu_torch.modules.module import ModuleError, Module


class ActivationType(str, Enum):
    sigmoid = "sigmoid"
    tanh = "tanh"
    relu = "relu"
    leakyRelu = "leakyRelu"
    elu = "elu"
    softPlus = "softPlus"
    clip = "clip"


sigmoid = ActivationType.sigmoid
tanh = ActivationType.tanh
relu = ActivationType.relu
leakyRelu = ActivationType.leakyRelu
elu = ActivationType.elu
softPlus = ActivationType.softPlus
clip = ActivationType.clip


# activation -> (forward, forward in place, derivative from the output)
_FUNCS = {
    ActivationType.relu: (ew.relu, ew.relu_, ew.reluDer),
}


class Activation(Module):
    def __init__(self, activation, inplace=False, name=None):
        super().__init__(name)

        self.gradUsesOutData = True

        self.inplace = inplace
        if inplace and Config.showWarnings:
            Config.getLogger().info("Warning: %s is using inplace flag", self)

        self.activation = ActivationType(activation)
        if self.activation not in _FUNCS:
            raise ModuleError("Activation %s is not ported yet" % activation)

    def updateData(self, data):
        fwd, fwdInplace, _ = _FUNCS[self.activation]
        self.data = fwdInplace(data) if self.inplace else fwd(data)

    def updateGrad(self, grad):
        der = _FUNCS[self.activation][2](grad, self.data)
        self.grad = grad.copy_(der) if self.inplace else der

    def dataShapeFrom(self, shape):
        return shape

    def gradShapeFrom(self, shape):
        return shape

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
