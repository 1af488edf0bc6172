"""Indexed max-pool / unpool dispatch (counterpart of
``puzzlelib_tpu/backend/kernels/pool.py``): the mask is the pooled maps'
flat argmax offsets (``ops.pool.maxpool2dWithIndex``); the masked pool's
backward and the unpool scatter through it, adding where windows overlap."""

from puzzlelib_tpu_torch.ops import pool as _pool


def maxpool2d(data, size, stride, pad):
    """(pooled, mask)."""
    return _pool.maxpool2dWithIndex(data, tuple(size), tuple(stride), tuple(pad))


def maxpool2dBackward(grad, origshape, mask, size, stride, pad):
    return _pool.maxunpool2d(grad, mask, tuple(origshape), tuple(size), tuple(stride), tuple(pad))


def maxunpool2d(data, origshape, mask, size, stride, pad):
    return _pool.maxunpool2d(data, mask, tuple(origshape), tuple(size), tuple(stride), tuple(pad))


def maxunpool2dBackward(grad, poolshape, mask):
    return _pool.maxunpool2dBackward(grad, mask)
