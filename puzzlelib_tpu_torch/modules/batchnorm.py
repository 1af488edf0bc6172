"""Per-activation batch norm on 2d (batch, size) data (counterpart of
``puzzlelib_tpu/modules/batchnorm.py``): statistics over the batch for each
of the ``size`` activations, on a (batch, size, 1, 1) view, with the factor
schedule, the affine switch and the ``empty`` / ``inplace`` flags of
``BatchNormND``."""

from puzzlelib_tpu_torch.backend.dnn import BatchNormMode
from puzzlelib_tpu_torch.modules.batchnormnd import BatchNormND
from puzzlelib_tpu_torch.modules.module import ModuleError


class BatchNorm(BatchNormND):
    mode = BatchNormMode.perActivation

    def __init__(self, size, epsilon=1e-5, initFactor=1.0, minFactor=0.1, sscale=0.01, affine=True, name=None,
                 empty=False, inplace=False):
        super().__init__(2, size, epsilon, initFactor, minFactor, sscale, affine, name, empty, inplace)
        self.size = size

    def _view(self, tensor):
        return tensor.reshape(tensor.shape[0], self.size, 1, 1)

    def checkDataShape(self, shape):
        if len(shape) != 2:
            raise ModuleError("Data must be 2d matrix")

        if shape[1] != self.size:
            raise ModuleError("Expected %d data dimensions, %d were given" % (self.size, shape[1]))

    def checkGradShape(self, shape):
        if len(shape) != 2:
            raise ModuleError("Grad must be 2d matrix")
