"""LRN across the maps (counterpart of ``puzzlelib_tpu/modules/crossmaplrn.py``,
AlexNet's): each cell divided by (K + alpha / N * the sum of squares over N
neighbouring maps at that pixel)^beta."""

from puzzlelib_tpu_torch.backend.dnn import crossMapLRN, crossMapLRNBackward
from puzzlelib_tpu_torch.modules.lrn import LRN


class CrossMapLRN(LRN):
    def __init__(self, N=5, alpha=1e-4, beta=0.75, K=2.0, name=None):
        super().__init__(N, alpha, beta, K, name)
        self.gradUsesOutData = True

    def updateData(self, data):
        self.data, self.workspace = crossMapLRN(data, N=self.N, alpha=self.alpha, beta=self.beta, K=self.K,
                                                test=not self.training)

    def updateGrad(self, grad):
        self.grad = crossMapLRNBackward(self.inData, self.data, grad, self.workspace,
                                        N=self.N, alpha=self.alpha, beta=self.beta, K=self.K)
