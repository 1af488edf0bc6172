"""LRN within each map (counterpart of ``puzzlelib_tpu/modules/maplrn.py``):
each cell divided by (K + alpha / N^2 * the sum of squares over its N x N
window)^beta."""

from puzzlelib_tpu_torch.backend.dnn import mapLRN, mapLRNBackward
from puzzlelib_tpu_torch.modules.lrn import LRN


class MapLRN(LRN):
    def __init__(self, N=5, alpha=1e-4, beta=0.75, K=2.0, name=None):
        super().__init__(N, alpha, beta, K, name)

    def updateData(self, data):
        self.data, self.workspace = mapLRN(data, None, N=self.N, alpha=self.alpha, beta=self.beta, K=self.K,
                                           test=not self.training)

    def updateGrad(self, grad):
        self.grad = mapLRNBackward(self.inData, self.data, grad, None, self.workspace,
                                   N=self.N, alpha=self.alpha, beta=self.beta, K=self.K)
