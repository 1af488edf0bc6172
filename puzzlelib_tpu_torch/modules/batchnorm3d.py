"""3-d batch normalization (counterpart of
``puzzlelib_tpu/modules/batchnorm3d.py``): ``BatchNormND`` on 5d data."""

from puzzlelib_tpu_torch.modules.batchnormnd import BatchNormND


class BatchNorm3D(BatchNormND):
    def __init__(self, maps, epsilon=1e-5, initFactor=1.0, minFactor=0.1, sscale=0.01, affine=True, name=None,
                 empty=False, inplace=False):
        super().__init__(3, maps, epsilon, initFactor, minFactor, sscale, affine, name, empty, inplace)

    def checkDataShape(self, shape):
        self.checkMapsShape(shape, 5, "Data")

    def checkGradShape(self, shape):
        self.checkMapsShape(shape, 5, "Grad")
