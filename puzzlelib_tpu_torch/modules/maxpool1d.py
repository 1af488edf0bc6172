"""1-d max pooling (counterpart of ``puzzlelib_tpu/modules/maxpool1d.py``)."""

from puzzlelib_tpu_torch.backend.dnn import PoolMode
from puzzlelib_tpu_torch.modules.pool1d import Pool1D


class MaxPool1D(Pool1D):
    def __init__(self, size=2, stride=2, pad=0, name=None):
        super().__init__(size, stride, pad, name)
        self.mode = PoolMode.max
