"""Optimizer hooks (counterpart of ``puzzlelib_tpu/optimizers/hooks.py``):
callables that the optimizer runs on each (variable, state) just before
its update.

``WeightDecay`` folds an L2 penalty into the gradient at ``rate`` times
the variable's own ``wc``, which starts at 0 and which nothing sets, as in
the reference: it acts only on variables whose ``wc`` a caller set, and in
global state, where the hook gets the flat variable, never.  ``GradClip``
scales each variable's gradient (in global state, the flat buffer's) to an
L2 norm of at most ``maxnorm``."""

import torch

from puzzlelib_tpu_torch.ops import elementwise as ew


class Hook:
    __slots__ = ()

    def __call__(self, var, state):
        raise NotImplementedError()


class WeightDecay(Hook):
    __slots__ = ("rate", )

    def __init__(self, rate):
        self.rate = rate

    def __call__(self, var, state):
        if var.grad.dtype != torch.float32:
            raise TypeError("weight decay expects fp32 grads, got %s" % var.grad.dtype)

        decay = self.rate * var.wc
        if decay > 0.0:
            ew.weightDecay_(var.grad, var.data, decay)


class GradClip(Hook):
    __slots__ = ("maxnorm", )

    def __init__(self, maxnorm):
        self.maxnorm = maxnorm

    def __call__(self, var, state):
        ew.gradClipNorm_(var.grad, self.maxnorm)
