"""Noise injection (counterpart of ``puzzlelib_tpu/modules/noiseinjector.py``).

In train mode the forward draws f32 noise of the data's shape from ``rng``
(``rng.globalRng`` by default): uniform over ``params`` = (a, b) or normal
with ``params`` = (mean, sigma); rounded to the data's type, it is added to
the data ("add") or multiplies it ("mul").  The backward passes the
gradient on ("add") or multiplies it by the same draws ("mul").  In eval
mode the module is the identity and draws nothing.  ``slicing`` (a slice of
the flat view) injects into the cells it selects only; ``inplace`` writes
over the input and the gradient, unless that tensor is a view of another.
``_drawRands`` is the one place that draws, so a test can inject the same
draws into both packages.
"""

from enum import Enum

import torch

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.backend.device import getDevice
from puzzlelib_tpu_torch.modules.module import Module


class InjectMode(str, Enum):
    add = "add"
    mul = "mul"


class NoiseType(str, Enum):
    gaussian = "gaussian"
    uniform = "uniform"


def _sliced(op, x, other, slc):
    """op(x, other), or, with a slice of the flat view, x with op applied to
    the cells the slice selects."""
    if slc is None:
        return op(x, other)

    out = x.clone()
    out.view(-1)[slc] = op(x.reshape(-1)[slc], other.reshape(-1)[slc])
    return out


class NoiseInjector(Module):
    def __init__(self, mode="add", noisetype="uniform", params=(0.0, 1.0), rng=None, inplace=False, slicing=None,
                 name=None):
        super().__init__(name)

        from puzzlelib_tpu_torch.rng import globalRng

        self.rng = globalRng if rng is None else rng
        self.mode = InjectMode(mode)
        self.type = NoiseType(noisetype)
        self.params = params

        self.slice = slicing
        self.rands = None

        self.inplace = inplace
        if inplace and Config.showWarnings:
            Config.getLogger().info("Warning: %s is using inplace flag", self)

    def _drawRands(self, shape):
        rands = torch.empty(shape, dtype=torch.float32, device=getDevice())

        if self.type == NoiseType.uniform:
            self.rng.fillUniform(rands, *self.params)
        else:
            self.rng.fillNormal(rands, *self.params)

        return rands

    def updateData(self, data):
        if not self.training:
            self.data = data
            return

        self.rands = self._drawRands(tuple(data.shape)).to(data.dtype)
        op = torch.add if self.mode == InjectMode.add else torch.mul
        self.data = self.writeOver(data, _sliced(op, data, self.rands, self.slice))

    def updateGrad(self, grad):
        if self.mode == InjectMode.mul:
            self.grad = self.writeOver(grad, _sliced(torch.mul, grad, self.rands, self.slice))
        else:
            self.grad = grad if self.inplace else grad.clone()

    def dataShapeFrom(self, shape):
        return shape

    def gradShapeFrom(self, shape):
        return shape

    def reset(self):
        super().reset()
        self.rands = None

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)
