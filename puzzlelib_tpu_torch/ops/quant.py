"""int8 quantized inference primitives (counterpart of
``puzzlelib_tpu/ops/quant.py``).

Activations are quantized symmetrically with a calibrated per-tensor scale,
weights per output channel, and every integer product goes to kernel K1-int8
(``ops/hopper/matmul.py``; in a trace its custom operator): int8 operands,
an exact int32 accumulator, int32 out.  The reference leaves its
products to XLA (``lax.dot_general`` and ``lax.conv_general_dilated`` at
``preferred_element_type=int32``); integer sums are exact, so K1-int8 gives
the same int32 values.  On CPU tensors the wrapper runs its plain version.
Dequantisation and the bias stay in f32, in the reference's order:
``acc * (wscale * xscale)``, then ``+ b``.

The conv is an im2col product: x is quantized first, then the int8 values
are laid out channels-last, padded with zeros (quantize(0) = 0, so the
padding is the conv's own) and gathered into an (N * OH * OW, KH * KW * C)
int8 matrix by one strided slice per filter tap, one product per group.
The gather copies the int8 bytes themselves, never a float copy of them (the
library's ``unfold`` has no int8 kernel), 8, 4 or 2 channels at a time as
one wider integer where C allows: VGG-16's conv1_2 at batch 32 writes
1,605,632 x 576 bytes = 0.92 GB.  The output is the NCHW view of the
channels-last product, as K2's is.
"""

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from puzzlelib_tpu_torch.ops.hopper import matmul as _k1


_WIDE = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.int8}


def quantizeWeight(w, axis):
    """Per-output-channel symmetric int8 quantisation of a weight array
    (numpy, as in the reference).

    Returns (wq int8, scale f32 broadcastable against w along ``axis``).
    """
    w = np.asarray(w, dtype=np.float32)

    reduceAxes = tuple(i for i in range(w.ndim) if i != axis)
    absmax = np.abs(w).max(axis=reduceAxes, keepdims=True)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)

    wq = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return wq, scale


def _scale(scale, like):
    """A per-tensor scale as a 0-d f32 tensor on ``like``'s device."""
    return torch.as_tensor(scale, dtype=torch.float32, device=like.device)


def _quantizeAct(x, scale):
    q = torch.clamp(torch.round(x.float() / _scale(scale, x)), -127.0, 127.0)
    return q.to(torch.int8)


def _dequantize(acc, wscale, xscale, b):
    """f32 (M, O) from the int32 products: acc * (wscale * xscale) + b."""
    outscale = wscale.reshape(1, -1) * _scale(xscale, acc)
    out = acc.float() * outscale

    if b is not None:
        out = out + b.float().reshape(1, -1)

    return out


def quantLinear(x, wq, wscale, xscale, b):
    """y = dequant(int8(x) @ int8(w)) + b; wq is the (in, out) table, which
    an engine transposes once at build time for a transposed Linear; wscale
    holds one scale per output."""
    xq = _quantizeAct(x, xscale)
    acc = _k1.matmul(xq, wq)
    return _dequantize(acc, wscale, xscale, b)


def _outSize(size, k, stride, pad, dilation):
    return (size + 2 * pad - dilation * (k - 1) - 1) // stride + 1


def im2col(xq, ksize, stride, pad, dilation):
    """int8 NC* ``xq`` -> (N, *out, taps, C) int8, channels last: for each
    filter tap (in row-major order over ``ksize``) the strided slice of the
    zero-padded input that the tap meets at every output position."""
    nd = xq.dim() - 2
    xl = xq.movedim(1, -1)

    padding = []
    for p in reversed(pad):
        padding += [p, p]

    # the gather moves 8, 4 or 2 channels as one wider element where C allows:
    # the same bytes, in a fraction of the copies
    width = next(w for w in (8, 4, 2, 1) if xq.shape[1] % w == 0)
    xl = F.pad(xl, [0, 0] + padding).contiguous().view(_WIDE[width])

    out = [_outSize(xq.shape[2 + i], ksize[i], stride[i], pad[i], dilation[i]) for i in range(nd)]

    taps = []
    for offsets in itertools.product(*[range(k) for k in ksize]):
        index = [slice(None)]
        for i, o in enumerate(offsets):
            start = o * dilation[i]
            index.append(slice(start, start + stride[i] * (out[i] - 1) + 1, stride[i]))

        taps.append(xl[tuple(index)])

    return torch.stack(taps, dim=-2).view(torch.int8)


def convOperand(wq, groups):
    """An int8 conv table (O, C / groups, *k) as K1-int8's operands: (groups,
    taps * C / groups, O / groups), K ordered (tap, channel) as ``im2col``
    gathers.  An engine lays it out once, at build time."""
    o, cg = wq.shape[:2]
    taps = wq[0, 0].numel()
    wmat = wq.reshape(groups, o // groups, cg, taps).permute(0, 3, 2, 1)
    return wmat.reshape(groups, taps * cg, o // groups).contiguous()


def convAcc(xq, wmat, ksize, stride, pad, dilation):
    """The int32 products of the int8 conv: ``xq`` int8 NC*, ``wmat`` the
    table as ``convOperand`` lays it out, for a filter of ``ksize`` ->
    (N * prod(out), O) int32, rows in (N, *out) order.  One K1-int8 product
    per group."""
    groups = wmat.shape[0]
    c = xq.shape[1]
    taps = int(np.prod(ksize))

    cols = im2col(xq, ksize, stride, pad, dilation)      # (N, *out, taps, C)
    rows = cols.numel() // (taps * c)

    if groups == 1:
        return _k1.matmul(cols.reshape(rows, taps * c), wmat[0])

    cols = cols.reshape(rows, taps, groups, c // groups)
    return torch.cat([
        _k1.matmul(cols[:, :, g].reshape(rows, taps * c // groups).contiguous(), wmat[g])
        for g in range(groups)
    ], dim=1)


def quantConvNd(x, wmat, ksize, wscale, xscale, b, stride, pad, dilation):
    """int8 conv: ``wmat`` is the (O, C / groups, *k) table as
    ``convOperand`` lays it out, for a filter of ``ksize``; wscale holds one
    scale per output map, b is (1, O, 1, ...) or (O, ) or None.  Returns f32
    NC* with channels-last strides."""
    nd = x.dim() - 2
    xq = _quantizeAct(x, xscale)

    acc = convAcc(xq, wmat, tuple(ksize), tuple(stride), tuple(pad), tuple(dilation))
    out = _dequantize(acc, wscale, xscale, b)

    n = x.shape[0]
    spatial = [_outSize(x.shape[2 + i], ksize[i], stride[i], pad[i], dilation[i]) for i in range(nd)]
    return out.reshape([n] + spatial + [acc.shape[1]]).movedim(-1, 1)
