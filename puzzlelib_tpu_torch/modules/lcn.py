"""Local contrast normalization (counterpart of ``puzzlelib_tpu/modules/lcn.py``):
u = x - the mean of x over an N x N window (an average pool at stride 1,
pad N // 2, pad cells counted or not as ``includePad`` says), then y =
u / (K + alpha / N^2 * the window sum of u^2)^beta.

The reference differentiates x -> y as one VJP.  Here the backward is
written out: y depends on x only through u = x - P x, with P the average
pool, so dx = du - P^T du, where du is the divisive normalization's
gradient in u (``divNormBackward``'s first result) and P^T du the pool's
backward of du."""

from puzzlelib_tpu_torch.backend.dnn import PoolMode, mapLRN, mapLRNBackward, poolNd, poolNdBackward
from puzzlelib_tpu_torch.modules.module import ModuleError
from puzzlelib_tpu_torch.modules.lrn import LRN


class LCN(LRN):
    def __init__(self, N=5, alpha=1e-4, beta=0.75, K=2.0, includePad=True, name=None):
        super().__init__(N, alpha, beta, K, name)

        if N % 2 != 1 or N == 1:
            raise ModuleError("LCN size must be odd and > 1")

        self.includePad = includePad
        self.mode = PoolMode.avgWithPad if includePad else PoolMode.avgNoPad
        self.means = None

    def _pool(self):
        return dict(size=(self.N, self.N), stride=(1, 1), pad=(self.N // 2, self.N // 2), mode=self.mode)

    def updateData(self, data):
        self.means, _ = poolNd(data, test=not self.training, **self._pool())
        self.data, self.workspace = mapLRN(data, self.means, N=self.N, alpha=self.alpha, beta=self.beta, K=self.K,
                                           test=not self.training)

    def updateGrad(self, grad):
        du, _ = mapLRNBackward(self.inData, self.data, grad, self.means, self.workspace,
                               N=self.N, alpha=self.alpha, beta=self.beta, K=self.K)
        self.grad = du - poolNdBackward(self.inData, self.means, du, None, **self._pool())

    def reset(self):
        super().reset()
        self.means = None
