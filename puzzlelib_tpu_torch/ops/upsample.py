"""Upsampling of (N, C, *spatial) tensors by integer factors, nearest and
linear, and their exact adjoints (counterpart of
``puzzlelib_tpu/ops/upsample.py``).  ``scale`` is a factor per spatial
axis.

- nearest repeats each cell ``scale`` times along each axis (a broadcast
  copy); its backward adds each block of the gradient in f32, the block's
  cells one after another in a fixed order, and rounds once to the
  gradient's type.
- linear is the reference's align-corners interpolation, axis after axis
  in f32 (the sampling positions o * (in - 1) / (out - 1), each output
  cell the lerp of its two neighbours), rounded once to x's type.  Its
  backward is the exact adjoint, axis by axis in reverse: one f32 product
  of the gradient with the (out, in) interpolation matrix per axis.  The
  library's align-corners backward adds with atomics in an order that
  changes from run to run on the card; the products do not.
"""

import torch


def _nearest(x, scale):
    n, c, *spatial = x.shape
    view, expanded = [n, c], [n, c]
    for extent, s in zip(spatial, scale):
        view += [extent, 1]
        expanded += [extent, s]

    return x.reshape(view).expand(expanded).reshape([n, c] + [e * s for e, s in zip(spatial, scale)])


def _nearestBackward(grad, scale):
    acc = grad.float()
    for i, s in enumerate(scale):
        blocks = acc.unflatten(2 + i, (-1, s))
        acc = blocks.select(3 + i, 0)
        for k in range(1, s):
            acc = acc + blocks.select(3 + i, k)

    return acc.to(grad.dtype)


def _taps(insz, outsz, device):
    """(lo, hi, frac) of the align-corners sampling of ``outsz`` cells from
    ``insz``, in f32 as the reference computes them."""
    pos = torch.arange(outsz, dtype=torch.float32, device=device) * ((insz - 1) / (outsz - 1))
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.clamp(lo + 1, max=insz - 1)
    return lo, hi, pos - lo.to(torch.float32)


def _linear(x, scale):
    xf = x.float()

    for i, s in enumerate(scale):
        axis, insz = 2 + i, x.shape[2 + i]
        if insz == 1:
            xf = xf.repeat_interleave(s, dim=axis)
            continue

        lo, hi, frac = _taps(insz, insz * s, x.device)
        shape = [1] * xf.dim()
        shape[axis] = insz * s
        frac = frac.view(shape)

        xf = xf.index_select(axis, lo) * (1 - frac) + xf.index_select(axis, hi) * frac

    return xf.to(x.dtype)


def _interpolationMatrix(insz, outsz, device):
    """M (outsz, insz) with y = M x along one axis."""
    if insz == 1:
        return torch.ones(outsz, 1, device=device)

    lo, hi, frac = _taps(insz, outsz, device)
    eye = torch.eye(insz, device=device)
    return eye[lo] * (1 - frac)[:, None] + eye[hi] * frac[:, None]


def _linearBackward(grad, scale):
    acc = grad.float()

    for i in reversed(range(len(scale))):
        axis = 2 + i
        outsz = acc.shape[axis]
        M = _interpolationMatrix(outsz // scale[i], outsz, grad.device)
        acc = torch.matmul(acc.movedim(axis, -1), M).movedim(-1, axis)

    return acc.to(grad.dtype)


def upsample(x, scale, mode="nearest"):
    return _nearest(x, scale) if mode == "nearest" else _linear(x, scale)


def upsampleBackward(grad, scale, mode="nearest"):
    """The gradient of ``upsample(x, scale, mode)`` with respect to x, given
    the gradient of its output."""
    return _nearestBackward(grad, scale) if mode == "nearest" else _linearBackward(grad, scale)
