"""2-d batch normalization (counterpart of
``puzzlelib_tpu/modules/batchnorm2d.py``): ``BatchNormND`` on 4d data."""

from puzzlelib_tpu_torch.modules.batchnormnd import BatchNormND


class BatchNorm2D(BatchNormND):
    def __init__(self, maps, epsilon=1e-5, initFactor=1.0, minFactor=0.1, sscale=0.01, affine=True, name=None,
                 empty=False, inplace=False):
        super().__init__(2, maps, epsilon, initFactor, minFactor, sscale, affine, name, empty, inplace)

    def checkDataShape(self, shape):
        self.checkMapsShape(shape, 4, "Data")

    def checkGradShape(self, shape):
        self.checkMapsShape(shape, 4, "Grad")
