"""Mean absolute error (counterpart of ``puzzlelib_tpu/cost/abs.py``): the
error normalised per sample, the gradient by the whole count of cells
(``ops.cost.abscost``); the validation error divided by the batch, on the
host in f64 for ``calcVal``, as the reference's, and in f32 on the device
for ``calcValDev``."""

from puzzlelib_tpu_torch.ops import cost as costOps
from puzzlelib_tpu_torch.cost.cost import Cost, requireSampleShape


class Abs(Cost):
    def calcGrad(self, pred, target):
        err, grad = costOps.abscost(pred, target)
        self.devErr.copy_(err)
        return grad

    def calcVal(self, pred, target):
        err, _ = costOps.abscost(pred, target)
        return err.item() / pred.shape[0]

    def calcValDev(self, pred, target):
        err, _ = costOps.abscost(pred, target)
        return err / pred.shape[0]

    def checkDataShape(self, pred, target):
        requireSampleShape("Abs", pred, target)

    def checkValDataShape(self, pred, target):
        requireSampleShape("Abs", pred, target)
