"""Pooling in NCHW layout, max and average modes (counterpart of
``puzzlelib_tpu/ops/pool.py``).

- max: the reference pads with -inf, which is what
  ``torch.nn.functional.max_pool{1,2,3}d`` does.  Its backward is the VJP
  of ``lax.reduce_window`` max, which XLA lowers to select-and-scatter: each
  window's gradient goes to one cell, the first maximum in window order, and
  overlapping windows add.  ``poolNdBackward`` recomputes the forward with
  the argmax indices, which the library also takes as the first maximum in
  window order (its kernels replace the running maximum only on a strictly
  greater value), and scatters the gradient through them.
- avgWithPad: the mean over the whole window, pad cells counted
  (``count_include_pad=True``: without ceil mode no window reaches past the
  pad, so the divisor is the window's size);
- avgNoPad: the mean over the window's cells inside the input
  (``count_include_pad=False``).

The average modes sum in f32 and round the mean once to x's type, as the
reference does; their backward is the VJP of that: the gradient in f32
spread over each window, rounded once.
"""

import torch
import torch.nn.functional as F


MODE_MAX = "max"
MODE_AVG_WITH_PAD = "avgWithPad"
MODE_AVG_NO_PAD = "avgNoPad"

_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_MAXPOOL_BACKWARD = {2: torch.ops.aten.max_pool2d_with_indices_backward,
                     3: torch.ops.aten.max_pool3d_with_indices_backward}

_AVGPOOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}
_AVGPOOL_BACKWARD = {2: torch.ops.aten.avg_pool2d_backward, 3: torch.ops.aten.avg_pool3d_backward}


def _includePad(mode):
    if mode not in (MODE_AVG_WITH_PAD, MODE_AVG_NO_PAD):
        raise ValueError("Unknown pool mode %s" % mode)

    return mode == MODE_AVG_WITH_PAD


def poolNd(x, size, stride, pad, mode=MODE_MAX):
    nd = x.dim() - 2

    if mode == MODE_MAX:
        return _MAXPOOL[nd](x, size, stride, pad)

    return _AVGPOOL[nd](x.float(), size, stride, pad, count_include_pad=_includePad(mode)).to(x.dtype)


def poolNdBackward(grad, x, size, stride, pad, mode=MODE_MAX):
    """The gradient of ``poolNd(x, ...)`` with respect to x, given the
    gradient of its output."""
    nd = x.dim() - 2

    if mode == MODE_MAX:
        if nd not in _MAXPOOL_BACKWARD:
            raise NotImplementedError("%d-d max-pool backward is not ported yet" % nd)

        _, indices = _MAXPOOL[nd](x, size, stride, pad, return_indices=True)
        return _MAXPOOL_BACKWARD[nd](grad, x, size, stride, pad, (1, ) * nd, False, indices)

    includePad = _includePad(mode)
    if nd not in _AVGPOOL_BACKWARD:
        raise NotImplementedError("%d-d average-pool backward is not ported yet" % nd)

    ingrad = _AVGPOOL_BACKWARD[nd](grad.float(), x.float(), size, stride, pad, False, includePad, None)
    return ingrad.to(grad.dtype)
