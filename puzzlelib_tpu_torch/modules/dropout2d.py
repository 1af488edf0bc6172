"""Per-map dropout (counterpart of ``puzzlelib_tpu/modules/dropout2d.py``):
one draw per (image, map), spread over the map.  The reference's kernel
ignores ``slicing`` here, and so does the port."""

from puzzlelib_tpu_torch.modules.dropout import Dropout
from puzzlelib_tpu_torch.ops import elementwise as ew


class Dropout2D(Dropout):
    def updateData(self, data):
        if not self.training:
            self.data = data
            return

        batchsize, maps = data.shape[:2]
        self.rands = self._drawRands(batchsize * maps).reshape(batchsize, maps)
        self.partition, p = self._keep()
        self.data = self.writeOver(data, ew.dropout2d(data, self.rands, self.partition, p))

    def updateGrad(self, grad):
        if not self.training:
            self.grad = grad
            return

        self.grad = self.writeOver(grad, ew.dropout2d(grad, self.rands, self.partition, 1.0 - self.p))
