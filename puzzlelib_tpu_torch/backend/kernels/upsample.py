"""Upsample dispatch (counterpart of
``puzzlelib_tpu/backend/kernels/upsample.py``): one factor for every
spatial axis, or a factor per axis."""

from puzzlelib_tpu_torch.ops import upsample as _up


def _scaleTuple(scale, nd):
    return (scale, ) * nd if isinstance(scale, int) else tuple(scale)


def upsample2d(data, scale, mode="nearest"):
    return _up.upsample(data, _scaleTuple(scale, 2), mode=mode)


def upsample2dBackward(grad, scale, mode="nearest"):
    return _up.upsampleBackward(grad, _scaleTuple(scale, 2), mode=mode)


def upsample3d(data, scale, mode="nearest"):
    return _up.upsample(data, _scaleTuple(scale, 3), mode=mode)


def upsample3dBackward(grad, scale, mode="nearest"):
    return _up.upsampleBackward(grad, _scaleTuple(scale, 3), mode=mode)
