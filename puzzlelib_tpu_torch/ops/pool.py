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

The max pool with explicit indices (``maxpool2dWithIndex``, for
``MaxUnpool2D``) keeps each window's first maximum, as ``jnp.argmax`` does,
as a flat offset into its (h, w) map.  Unpooling scatters through those
offsets and adds where overlapping windows picked the same cell, as the
reference's ``.at[...].add`` does.  It adds window offset by window offset,
one strided elementwise add each, in a fixed order, where the library's
scatter-add (and ``max_unpool2d``, which keeps one of two colliding values)
adds with atomics in an order that changes from run to run on the card; so
the CPU and the card give the same bits.
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


# -- max pool with explicit indices (for MaxUnpool2D) ------------------------

def maxpool2dWithIndex(x, size, stride, pad):
    """(pooled, indices): each window's maximum and the flat offset (row * w
    + col) of its first maximum in window order within x's (h, w) map."""
    return F.max_pool2d(x, size, stride, pad, return_indices=True)


def _windowCells(oh, ow, inshape, stride, pad, dy, dx, device):
    """(oh, ow) flat offsets of cell (dy, dx) of each window in maps of
    ``inshape``, -1 where that cell lies in the pad."""
    (h, w), (sh, sw), (ph, pw) = inshape, stride, pad
    rows = (torch.arange(oh, device=device) * sh - ph + dy).view(oh, 1)
    cols = (torch.arange(ow, device=device) * sw - pw + dx).view(1, ow)

    inside = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    return torch.where(inside, rows * w + cols, -1)


def maxunpool2d(x, idx, inshape, size, stride, pad):
    """x (N, C, oh, ow) scattered into zeros of the maps ``inshape[2:]`` at
    the flat offsets ``idx`` of ``maxpool2dWithIndex(..., size, stride,
    pad)``, adding where windows overlap: one strided add a window cell, in
    window order, of the values whose window took its maximum there."""
    (kh, kw), (sh, sw), (ph, pw) = size, stride, pad
    n, c, oh, ow = x.shape
    h, w = inshape[2], inshape[3]
    spanH, spanW = (oh - 1) * sh + 1, (ow - 1) * sw + 1

    out = x.new_zeros(n, c, max(h + 2 * ph, spanH + kh - 1), max(w + 2 * pw, spanW + kw - 1))
    zero = x.new_zeros(())

    for dy in range(kh):
        for dx in range(kw):
            cells = _windowCells(oh, ow, (h, w), stride, pad, dy, dx, x.device)
            out[:, :, dy:dy + spanH:sh, dx:dx + spanW:sw].add_(torch.where(idx == cells, x, zero))

    return out[:, :, ph:ph + h, pw:pw + w].contiguous()


def maxunpool2dBackward(grad, idx):
    """The gradient of ``maxunpool2d`` with respect to x: the gradient read
    at each window's offset (a gather)."""
    n, c = idx.shape[:2]
    return torch.gather(grad.reshape(n, c, -1), 2, idx.reshape(n, c, -1)).reshape(idx.shape)
