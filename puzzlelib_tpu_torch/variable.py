"""Trainable parameter wrapper (counterpart of ``puzzlelib_tpu/variable.py``).

``data`` is an ``nn.Parameter`` (with ``requires_grad`` off: PuzzleLib runs
its own backward passes), so the module that registers it through
``Module.setVar`` exposes it to ``parameters()``, ``state_dict()`` and
``.to()``.  The parameter aliases the tensor it is given: under an
optimizer's global state that tensor is a view of one flat buffer, and every
write to the parameter goes through to it.  ``grad`` is a zero buffer of the
same shape, allocated unless ``withgrad`` is off or ``Config.globalEvalMode``
is set.

``learnRate``, ``momRate`` and ``wc`` scale the optimizer's own rates for
this variable.  A variable with an ``updater`` owns no gradient: the callable
is its whole update, which the optimizer runs after its own.
"""

import itertools

import torch

from puzzlelib_tpu_torch import config as Config


_anonymous = itertools.count()


class Variable:
    def __init__(self, data, name=None, withgrad=True, grad=None, updater=None):
        if name is None:
            name = str(next(_anonymous))

        if not isinstance(data, torch.nn.Parameter):
            data = torch.nn.Parameter(data, requires_grad=False)

        self.name, self.data = name, data
        self.updater = updater
        self.grad = None

        if updater is not None:
            return

        self.grad = self._allocGrad(withgrad) if grad is None else grad

        # per-variable multipliers applied on top of the optimizer's rates
        self.learnRate, self.momRate, self.wc = 1.0, 1.0, 0.0

    def _allocGrad(self, withgrad):
        if not withgrad or Config.globalEvalMode:
            return None

        return torch.zeros_like(self.data)

    @property
    def hasUpdater(self):
        return callable(self.updater)

    def update(self, learnRate):
        return self.updater(self, learnRate)
