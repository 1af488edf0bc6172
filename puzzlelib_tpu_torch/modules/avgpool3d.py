"""3-d average pooling (counterpart of ``puzzlelib_tpu/modules/avgpool3d.py``):
``includePad`` counts the pad cells in each window's divisor."""

from puzzlelib_tpu_torch.backend.dnn import PoolMode
from puzzlelib_tpu_torch.modules.pool3d import Pool3D


class AvgPool3D(Pool3D):
    def __init__(self, size=2, stride=2, pad=0, includePad=True, name=None):
        super().__init__(size, stride, pad, name)
        self.mode = PoolMode.avgWithPad if includePad else PoolMode.avgNoPad
