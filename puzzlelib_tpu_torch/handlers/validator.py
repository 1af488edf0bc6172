"""Validation handler (counterpart of ``puzzlelib_tpu/handlers/validator.py``).

The module goes to eval mode, walks the data in batches in order, and the
cost's validation error of each batch, weighted by the batch's size, is
summed into one f64 scalar on the device (``Cost.validateDev``): one
readback a call, where the reference reads each batch's error back.  Each
batch's error is the f32 value the reference reads, and the weighted sum
runs in f64 in the same order as the reference's sum of Python floats, so
the error returned is the reference's to the bit.  A list of targets
(``Multi``, which has no device error) takes the reference's way: the
costs' errors read back each batch (``cost.validate``), summed on the host,
and the validation error is a list, one per cost."""

import torch

from puzzlelib_tpu_torch.handlers.handler import Handler


class Validator(Handler):
    def __init__(self, mod, cost, onBatchFinish=None, batchsize=128):
        super().__init__(mod, onBatchFinish, batchsize)

        self.error = 0.0
        self.cost = cost

    def validateFromHost(self, data, target, macroBatchSize=10000, onMacroBatchFinish=None):
        state = {"error": None}

        self.module.evalMode()
        self.handleFromHost([data, target], state, macroBatchSize, onMacroBatchFinish, random=False)

        return self._finish(state, target)

    def validate(self, data, target):
        state = {"error": None}

        self.module.evalMode()
        self.handle([data, target], state, random=False)

        return self._finish(state, target)

    def _finish(self, state, target):
        error, size = state["error"], self.getDataSize(target)
        self.error = [e / size for e in error] if isinstance(error, list) else error.item() / size
        return self.error

    def handleBatch(self, batch, idx, state):
        data, target = batch

        if isinstance(target, list):
            self._addHostError(state, data, self.cost.validate(self.module(data), target))
            return

        self._addError(state, data, self.cost.validateDev(self.module(data), target))

    def _addHostError(self, state, data, error):
        """Add a batch's error read back by ``cost.validate`` (a float, or a
        list of them, one per cost), weighted by the batch's size."""
        if not isinstance(error, list):
            self._addError(state, data, torch.tensor(error, dtype=torch.float64))
            return

        batchErrors = [self.getDataSize(data) * e for e in error]
        state["error"] = batchErrors if state["error"] is None else [
            acc + e for acc, e in zip(state["error"], batchErrors)
        ]

    def _addError(self, state, data, error):
        """Add the batch's error (a 0-d tensor), weighted by its size, to
        the sum in f64."""
        batchError = self.getDataSize(data) * error.double()
        state["error"] = batchError if state["error"] is None else state["error"] + batchError
