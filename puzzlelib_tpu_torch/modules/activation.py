"""Elementwise activation module (counterpart of
``puzzlelib_tpu/modules/activation.py``): the seven activations with their
default arguments (``args`` overrides them), each a PyTorch op, as the
reference leaves them to XLA.  ``slc`` (a slice of the flat view) applies the
activation to the cells it selects and passes the rest through.  The
derivative is taken from the output (``gradUsesOutData``).  An inplace module
writes its output over its input and its gradient over the incoming one,
unless that tensor is a view of another (a ``Concat`` backward's split, a
slice): it never writes through a view it does not own."""

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


# activation -> (forward, derivative from (outgrad, outdata), default args)
_FUNCS = {
    ActivationType.sigmoid: (ew.sigmoid, ew.sigmoidDer, ()),
    ActivationType.tanh: (ew.tanh, ew.tanhDer, ()),
    ActivationType.relu: (ew.relu, ew.reluDer, ()),
    ActivationType.leakyRelu: (ew.leakyRelu, ew.leakyReluDer, (0.01, )),
    ActivationType.elu: (ew.elu, ew.eluDer, (1.0, )),
    ActivationType.softPlus: (ew.softPlus, ew.softPlusDer, ()),
    ActivationType.clip: (ew.clip, ew.clipDer, (0.0, 6.0)),
}


def _overSlice(fn, tensors, args, slc):
    """fn over the whole tensors, or over a slice of their flat views with the
    first tensor passed through elsewhere."""
    if slc is None:
        return fn(*tensors, *args)

    head = tensors[0].reshape(-1)
    out = head.clone()
    out[slc] = fn(head[slc], *(t.reshape(-1)[slc] for t in tensors[1:]), *args)
    return out.reshape(tensors[0].shape)


class Activation(Module):
    def __init__(self, activation, slc=None, inplace=False, name=None, args=()):
        super().__init__(name)
        self.registerBlueprint(locals())

        self.gradUsesOutData = True

        self.inplace = inplace
        if inplace and Config.showWarnings:
            Config.getLogger().info("Warning: %s is using inplace flag", self)

        self.activation = ActivationType(activation)
        if self.activation not in _FUNCS:
            raise ModuleError("Unrecognized activation %s" % activation)

        self.slc = slc
        self.actArgs = tuple(args) if len(args) > 0 else _FUNCS[self.activation][2]

    def updateData(self, data):
        fwd = _FUNCS[self.activation][0]
        self.data = self.writeOver(data, _overSlice(fwd, (data, ), self.actArgs, self.slc))

    def updateGrad(self, grad):
        der = _FUNCS[self.activation][1]
        self.grad = self.writeOver(grad, _overSlice(der, (grad, self.data), self.actArgs, self.slc))

    def dataShapeFrom(self, shape):
        return shape

    def gradShapeFrom(self, shape):
        return shape

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
