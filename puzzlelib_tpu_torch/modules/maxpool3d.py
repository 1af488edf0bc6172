"""3-d max pooling (counterpart of ``puzzlelib_tpu/modules/maxpool3d.py``):
pad cells are -inf, and each window's gradient goes to its first maximum."""

from puzzlelib_tpu_torch.backend.dnn import PoolMode
from puzzlelib_tpu_torch.modules.pool3d import Pool3D


class MaxPool3D(Pool3D):
    def __init__(self, size=2, stride=2, pad=0, name=None):
        super().__init__(size, stride, pad, name)
        self.mode = PoolMode.max
