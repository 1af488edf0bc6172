"""Local response normalization base (counterpart of
``puzzlelib_tpu/modules/lrn.py``): the window N, alpha, beta and K of the
denominator (K + alpha / n * window sum of squares)^beta for ``MapLRN``,
``CrossMapLRN`` and ``LCN``.  Shapes pass through; ``workspace`` keeps the
denominator of the last train forward, which the backward reads again
(``ops/norm.py``).  Like the reference's, these modules take f32 only (the
base ``calcMode``)."""

from puzzlelib_tpu_torch.modules.module import ModuleError, Module


class LRN(Module):
    def __init__(self, N=5, alpha=1e-4, beta=0.75, K=2.0, name=None):
        super().__init__(name)
        self.registerBlueprint(locals())

        self.N, self.alpha, self.beta, self.K = N, alpha, beta, K
        self.workspace = None

    def _expectRank4(self, shape, what):
        if len(shape) != 4:
            raise ModuleError("%s must be 4d tensor" % what)

    def dataShapeFrom(self, shape):
        return shape

    def checkDataShape(self, shape):
        self._expectRank4(shape, "Data")

    def checkGradShape(self, shape):
        self._expectRank4(shape, "Grad")

    gradShapeFrom = dataShapeFrom

    def reset(self):
        super().reset()
        self.workspace = None
