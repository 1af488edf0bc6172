"""Several costs over a multi-output net (counterpart of
``puzzlelib_tpu/cost/multi.py``): cost i takes prediction i and target i;
the errors, mean errors and validation errors are lists, one per cost.
Each cost keeps its own accumulators.  There is no ``calcValDev``: a list
of errors is read back per batch (``Validator`` and ``FusedValidator`` take
the eager path for it, as the reference's do)."""

from puzzlelib_tpu_torch.cost.cost import Cost, CostError


class Multi(Cost):
    def __init__(self):
        self.costs = []
        super().__init__()

        # no accumulators of its own: each cost keeps its own
        self.devErr = self.accumErr = None

    def append(self, cost):
        self.costs.append(cost)
        return self

    def _paired(self, preds, targets):
        return zip(self.costs, preds, targets)

    # -- the accumulators, fanned out ------------------------------------------------

    def resetAccumulator(self):
        for cost in self.costs:
            cost.resetAccumulator()

    def resetDeviceAccumulator(self):
        for cost in self.costs:
            cost.resetDeviceAccumulator()

    def updateState(self, samples):
        for cost in self.costs:
            cost.updateState(samples)

    def getError(self):
        if self.dirty:
            self.error, self.dirty = [cost.getError() for cost in self.costs], False

        return self.error

    def getMeanError(self):
        return [cost.getMeanError() for cost in self.costs]

    # -- pairwise evaluation ---------------------------------------------------------

    def calcGrad(self, preds, targets):
        grads = []
        for cost, pred, target in self._paired(preds, targets):
            cost.grad = cost.calcGrad(pred, target)
            grads.append(cost.grad)

        return grads

    def calcError(self, preds, targets):
        for cost, pred, target in self._paired(preds, targets):
            cost.calcError(pred, target)

    def calcVal(self, preds, targets):
        return [cost.calcVal(pred, target) for cost, pred, target in self._paired(preds, targets)]

    def checkDataShape(self, preds, targets):
        self._pairs(preds, targets)

        for cost, pred, target in self._paired(preds, targets):
            cost.checkDataShape(pred, target)

    def checkValDataShape(self, preds, targets):
        self._pairs(preds, targets)

        for cost, pred, target in self._paired(preds, targets):
            cost.checkValDataShape(pred, target)

    def _pairs(self, preds, targets):
        if len(preds) != len(targets):
            raise CostError("Multi takes as many predictions as targets, got %d and %d" % (len(preds), len(targets)))

    def getBatchsize(self, preds):
        return preds[0].shape[0]
