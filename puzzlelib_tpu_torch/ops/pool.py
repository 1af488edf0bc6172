"""Pooling in NCHW layout, max mode (counterpart of
``puzzlelib_tpu/ops/pool.py``).

The reference's max mode pads with -inf, which is what
``torch.nn.functional.max_pool{1,2,3}d`` does.  Its backward is the VJP of
``lax.reduce_window`` max, which XLA lowers to select-and-scatter: each
window's gradient goes to one cell, the first maximum in window order, and
overlapping windows add.  ``poolNdBackward`` recomputes the forward with the
argmax indices, which the library also takes as the first maximum in window
order (its kernels replace the running maximum only on a strictly greater
value), and scatters the gradient through them.  The average modes come
with the modules that use them.
"""

import torch
import torch.nn.functional as F


MODE_MAX = "max"

_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_MAXPOOL_BACKWARD = {2: torch.ops.aten.max_pool2d_with_indices_backward,
                     3: torch.ops.aten.max_pool3d_with_indices_backward}


def poolNd(x, size, stride, pad, mode=MODE_MAX):
    if mode != MODE_MAX:
        raise NotImplementedError("pool mode %s is not ported yet" % mode)

    return _MAXPOOL[x.dim() - 2](x, size, stride, pad)


def poolNdBackward(grad, x, size, stride, pad, mode=MODE_MAX):
    """The gradient of ``poolNd(x, ...)`` with respect to x, given the
    gradient of its output."""
    if mode != MODE_MAX:
        raise NotImplementedError("pool mode %s is not ported yet" % mode)

    nd = x.dim() - 2
    if nd not in _MAXPOOL_BACKWARD:
        raise NotImplementedError("%d-d max-pool backward is not ported yet" % nd)

    _, indices = _MAXPOOL[nd](x, size, stride, pad, return_indices=True)
    return _MAXPOOL_BACKWARD[nd](grad, x, size, stride, pad, (1, ) * nd, False, indices)
