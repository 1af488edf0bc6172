"""Reflect-pad dispatch (counterpart of ``puzzlelib_tpu/backend/kernels/pad.py``).

Pad formats follow the reference kernels: 1-d pad = (lpad, rpad); 2-d pad =
(upad, bpad, lpad, rpad).  Tuples of per-axis (lo, hi) pairs are also
accepted.
"""

from puzzlelib_tpu_torch.ops import pad as _pad


def _toPairs(pad, nd):
    pad = tuple(pad)

    if len(pad) == nd and all(isinstance(p, (tuple, list)) for p in pad):
        return tuple((int(lo), int(hi)) for lo, hi in pad)

    if len(pad) == 2 * nd:
        return tuple((int(pad[2 * i]), int(pad[2 * i + 1])) for i in range(nd))

    if len(pad) == nd:
        return tuple((int(p), int(p)) for p in pad)

    raise ValueError("Bad pad spec %r for %dd padding" % (pad, nd))


def _reflectpad(data, pad):
    return _pad.reflectpad(data, _toPairs(pad, data.dim() - 2))


def _reflectpadBackward(grad, pad):
    return _pad.reflectpadBackward(grad, _toPairs(pad, grad.dim() - 2))


reflectpad1d = reflectpad2d = _reflectpad
reflectpad1dBackward = reflectpad2dBackward = _reflectpadBackward
