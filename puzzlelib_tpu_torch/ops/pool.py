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

The backward takes every nd the reference takes.  A 1-d pool's runs as
the 2-d one of the (N, C, T, 1) view.  The library's 2-d backwards gather
each input cell's windows, so they repeat bit for bit on the card; its
3-d ones add with atomics.  Where no two windows share a cell (C3D's
pools), each cell takes at most one add and the library's result repeats
too; where 3-d windows overlap (3x3x3 at stride 2), ``_scatterWindows``
adds the gradient window cell by window cell, one strided add each, in
f32 and in a fixed order, and rounds once to the gradient's type.

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

import itertools
import math

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


def _overlapping(size, stride):
    return any(k > s for k, s in zip(size, stride))


def poolNdBackward(grad, x, size, stride, pad, mode=MODE_MAX):
    """The gradient of ``poolNd(x, ...)`` with respect to x, given the
    gradient of its output."""
    nd = x.dim() - 2

    if nd == 1:
        ingrad = poolNdBackward(grad.unsqueeze(-1), x.unsqueeze(-1), tuple(size) + (1, ), tuple(stride) + (1, ),
                                tuple(pad) + (0, ), mode)
        return ingrad.squeeze(-1)

    scatter = nd == 3 and _overlapping(size, stride)

    if mode == MODE_MAX:
        _, indices = _MAXPOOL[nd](x, size, stride, pad, return_indices=True)
        if scatter:
            zero = grad.new_zeros(())
            return _scatterWindows(lambda cells: torch.where(indices == cells, grad, zero), tuple(x.shape), size,
                                   stride, pad, tuple(grad.shape[2:]), grad).to(grad.dtype)

        return _MAXPOOL_BACKWARD[nd](grad, x, size, stride, pad, (1, ) * nd, False, indices)

    includePad = _includePad(mode)
    if scatter:
        if includePad:
            counts = float(math.prod(size))
        else:
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=torch.float32, device=x.device)
            counts = _AVGPOOL[nd](ones, size, stride, pad, count_include_pad=False, divisor_override=1)

        spread = grad.to(_accumulator(grad)) / counts
        return _scatterWindows(lambda cells: spread, tuple(x.shape), size, stride, pad, tuple(grad.shape[2:]),
                               grad).to(grad.dtype)

    ingrad = _AVGPOOL_BACKWARD[nd](grad.float(), x.float(), size, stride, pad, False, includePad, None)
    return ingrad.to(grad.dtype)


def _windowCells(outSpatial, inSpatial, stride, pad, cell, device):
    """The flat offsets, within maps of ``inSpatial``, of window cell
    ``cell`` of each window of an ``outSpatial`` output; -1 where that cell
    lies in the pad."""
    nd = len(outSpatial)
    flat = torch.zeros((1, ) * nd, dtype=torch.int64, device=device)
    inside = torch.ones((1, ) * nd, dtype=torch.bool, device=device)

    for axis, (o, n, s, p, c) in enumerate(zip(outSpatial, inSpatial, stride, pad, cell)):
        coords = (torch.arange(o, device=device) * s - p + c).view((1, ) * axis + (o, ) + (1, ) * (nd - axis - 1))
        flat = flat * n + coords
        inside = inside & (coords >= 0) & (coords < n)

    return torch.where(inside, flat, -1)


def _accumulator(grad):
    """The type the window adds run in: f32, or f64 for an f64 gradient."""
    return torch.promote_types(grad.dtype, torch.float32)


def _scatterWindows(values, inshape, size, stride, pad, outSpatial, grad):
    """A tensor of ``inshape`` in ``_accumulator(grad)``'s type on grad's
    device in which each cell sums, over the windows that hold it,
    ``values(cells)`` (N, C, *outSpatial) of the window cell it is,
    ``cells`` being that window cell's offsets (``_windowCells``): one
    strided add a window cell, in window order."""
    spans = tuple((o - 1) * s + 1 for o, s in zip(outSpatial, stride))
    extents = tuple(max(n + 2 * p, span + k - 1) for n, p, span, k in zip(inshape[2:], pad, spans, size))
    out = torch.zeros(tuple(inshape[:2]) + extents, dtype=_accumulator(grad), device=grad.device)

    for cell in itertools.product(*(range(k) for k in size)):
        cells = _windowCells(outSpatial, inshape[2:], stride, pad, cell, out.device)
        window = (Ellipsis, ) + tuple(slice(c, c + span, s) for c, span, s in zip(cell, spans, stride))
        out[window].add_(values(cells).to(out.dtype))

    return out[(Ellipsis, ) + tuple(slice(p, p + n) for p, n in zip(pad, inshape[2:]))]


# -- max pool with explicit indices (for MaxUnpool2D) ------------------------

def maxpool2dWithIndex(x, size, stride, pad):
    """(pooled, indices): each window's maximum and the flat offset (row * w
    + col) of its first maximum in window order within x's (h, w) map."""
    return F.max_pool2d(x, size, stride, pad, return_indices=True)


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
            cells = _windowCells((oh, ow), (h, w), stride, pad, (dy, dx), x.device)
            out[:, :, dy:dy + spanH:sh, dx:dx + spanW:sw].add_(torch.where(idx == cells, x, zero))

    return out[:, :, ph:ph + h, pw:pw + w].contiguous()


def maxunpool2dBackward(grad, idx):
    """The gradient of ``maxunpool2d`` with respect to x: the gradient read
    at each window's offset (a gather)."""
    n, c = idx.shape[:2]
    return torch.gather(grad.reshape(n, c, -1), 2, idx.reshape(n, c, -1)).reshape(idx.shape)
