"""Trainable parameter wrapper (counterpart of ``puzzlelib_tpu/variable.py``).

``data`` is an ``nn.Parameter`` (with ``requires_grad`` off: PuzzleLib runs
its own backward passes), so the module that registers it through
``Module.setVar`` exposes it to ``parameters()``, ``state_dict()`` and
``.to()``.  ``grad`` is a zero buffer of the same shape, allocated unless
``withgrad`` is off or ``Config.globalEvalMode`` is set.  The optimizer
state (per-variable rates, updaters) comes with the optimizers.
"""

import itertools

import torch

from puzzlelib_tpu_torch import config as Config


_anonymous = itertools.count()


class Variable:
    def __init__(self, data, name=None, withgrad=True, grad=None):
        if name is None:
            name = str(next(_anonymous))

        if not isinstance(data, torch.nn.Parameter):
            data = torch.nn.Parameter(data, requires_grad=False)

        self.name, self.data = name, data
        self.grad = self._allocGrad(withgrad) if grad is None else grad

    def _allocGrad(self, withgrad):
        if not withgrad or Config.globalEvalMode:
            return None

        return torch.zeros_like(self.data)
