"""DNN primitive dispatch (counterpart of ``puzzlelib_tpu/backend/dnn.py``):
the conv, pool and softmax slots of the serving slice, forward only."""

from enum import Enum

from puzzlelib_tpu_torch.ops import conv as _conv
from puzzlelib_tpu_torch.ops import pool as _pool
from puzzlelib_tpu_torch.ops import softmax as _softmax


class PoolMode(Enum):
    max = "max"


class SoftMaxMode(Enum):
    perActivation = "perActivation"
    spatial = "spatial"


def _t(v):
    return tuple(int(x) for x in v)


def convNd(data, W, bias, stride, pad, dilation, groups):
    return _conv.convNd(data, W, bias, _t(stride), _t(pad), _t(dilation), int(groups))


def poolNd(data, size, stride, pad, mode=PoolMode.max, test=False):
    """(pooled, workspace); the workspace is None, as in the reference."""
    return _pool.poolNd(data, _t(size), _t(stride), _t(pad), mode.value), None


def softmaxNd(data, mode=SoftMaxMode.spatial):
    return _softmax.softmaxNd(data)
