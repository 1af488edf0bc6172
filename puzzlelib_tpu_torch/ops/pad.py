"""Reflect padding over the spatial axes of (N, C, *spatial) tensors and its
adjoint (counterpart of ``puzzlelib_tpu/ops/pad.py``).  ``pad`` is a tuple of
per-spatial-axis (lo, hi) pairs, each smaller than its axis, as reflect
padding needs.

The forward is ``torch.nn.functional.pad(mode="reflect")`` (the edge cell is
not repeated, as in ``jnp.pad(mode="reflect")``).  The backward folds each
axis's padded margins back onto the cells they mirror, axis by axis, with
slices and adds in the gradient's type, where the library's reflection-pad
backward adds with atomics in an order that changes from run to run on the
card."""

import torch.nn.functional as F


def reflectpad(x, pad):
    flat = [side for lo, hi in reversed(pad) for side in (lo, hi)]
    return F.pad(x, flat, mode="reflect")


def _foldAxis(grad, axis, lo, hi):
    n = grad.shape[axis] - lo - hi
    out = grad.narrow(axis, lo, n).clone()

    if lo > 0:
        out.narrow(axis, 1, lo).add_(grad.narrow(axis, 0, lo).flip(axis))

    if hi > 0:
        out.narrow(axis, n - 1 - hi, hi).add_(grad.narrow(axis, lo + n, hi).flip(axis))

    return out


def reflectpadBackward(grad, pad):
    """The gradient of ``reflectpad(x, pad)`` with respect to x, given the
    gradient of its output."""
    for i, (lo, hi) in enumerate(pad):
        grad = _foldAxis(grad, 2 + i, lo, hi)

    return grad
