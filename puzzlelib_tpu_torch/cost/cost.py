"""Cost base class with the error kept on the device (counterpart of
``puzzlelib_tpu/cost/cost.py``).

``devErr`` (the last batch's error sum) and ``accumErr`` (the running sum)
are 0-d f32 tensors on the device, so a training step reads nothing back
unless an error is asked for (``getError``, ``getMeanError``).

Validation: ``validate`` returns a batch's validation error as a float (one
readback), as the reference's does; ``validateDev`` returns it as a 0-d
tensor on the device with no readback, for ``Validator``, which sums the
batches on the device and reads the sum back once."""

import torch

from puzzlelib_tpu_torch.backend.device import getDevice


class CostError(Exception):
    pass


def requireLabelRange(tag, labels, low, high):
    """Raise CostError unless every label lies in [low, high]; one readback
    for both bounds."""
    lo, hi = torch.stack([labels.min(), labels.max()]).tolist()

    if lo < low:
        raise CostError("%s labels verification failed, found index %s (< %s)" % (tag, lo, low))

    if hi > high:
        raise CostError("%s labels verification failed, found index %s (> %s)" % (tag, hi, high))


def requireSampleShape(tag, pred, target):
    """Raise CostError unless the prediction and the target have one sample
    shape."""
    if tuple(pred.shape[1:]) != tuple(target.shape[1:]):
        raise CostError("%s takes a prediction and a target of one sample shape, got %s and %s" %
                        (tag, tuple(pred.shape), tuple(target.shape)))


class Cost:
    def __init__(self):
        self.devErr = torch.zeros((), dtype=torch.float32, device=getDevice())
        self.accumErr = torch.zeros((), dtype=torch.float32, device=getDevice())

        self.batchsize = 0
        self.numOfSamples = 0

        self.error = None
        self.valError = None
        self.grad = None
        self.dirty = True

    # -- accumulator lifecycle -------------------------------------------------

    def resetDeviceAccumulator(self):
        self.accumErr.zero_()

    def resetAccumulator(self):
        self.resetDeviceAccumulator()
        self.batchsize = self.numOfSamples = 0

    def updateState(self, samples):
        self.batchsize = samples
        self.numOfSamples += samples

    def reset(self):
        self.error = self.valError = self.grad = None

    # -- error queries: the only readbacks ----------------------------------------

    def getError(self):
        if self.dirty:
            self.error, self.dirty = self.devErr.item() / self.batchsize, False

        return self.error

    def getMeanError(self):
        return self.accumErr.item() / self.numOfSamples

    def getValError(self):
        return self.valError

    # -- evaluation protocol ----------------------------------------------------

    @staticmethod
    def _verifyBatch(pred, target):
        """Tensor pairs only: a cost whose prediction and target are tuples
        (``CTC``) checks them itself."""
        bothTensors = isinstance(pred, torch.Tensor) and isinstance(target, torch.Tensor)
        if bothTensors and pred.shape[0] != target.shape[0]:
            raise CostError("prediction/target batch mismatch: %d vs %d" % (pred.shape[0], target.shape[0]))

    def __call__(self, pred, target, queryError=True):
        self._verifyBatch(pred, target)
        self.checkDataShape(pred, target)
        self.reset()

        self.grad = grad = self.calcGrad(pred, target)
        self.calcError(pred, target)
        self.dirty = True
        self.updateState(self.getBatchsize(pred))

        if not queryError:
            return grad

        self.error = self.getError()
        return self.error, grad

    def validate(self, pred, target):
        """The batch's validation error, as a float."""
        self._verifyBatch(pred, target)
        self.checkValDataShape(pred, target)

        self.valError = self.calcVal(pred, target)
        return self.valError

    def validateDev(self, pred, target):
        """The batch's validation error as a 0-d f32 tensor on the device,
        read back only where ``Config.verifyData`` checks the labels."""
        self._verifyBatch(pred, target)
        self.checkValDataShape(pred, target)

        return self.calcValDev(pred, target)

    # -- subclass surface --------------------------------------------------------

    def getBatchsize(self, pred):
        return pred.shape[0]

    def calcGrad(self, pred, target):
        raise NotImplementedError()

    def calcError(self, pred, target):
        # calcGrad left the batch's error in devErr: fold it into the sum
        self.accumErr.add_(self.devErr)

    def calcVal(self, pred, target):
        return self.calcValDev(pred, target).item()

    def calcValDev(self, pred, target):
        """The batch's validation error as a 0-d f32 tensor on the device."""
        raise NotImplementedError()

    def checkDataShape(self, pred, target):
        pass

    def checkValDataShape(self, pred, target):
        pass
