"""int8 quantized inference primitives (counterpart of
``puzzlelib_tpu/ops/quant.py``).

Activations are quantized symmetrically with a calibrated per-tensor scale,
weights per output channel, and every integer product goes to kernel K1-int8
(``ops/hopper/matmul.py`` ``matmulNT``; in a trace its custom operator):
int8 operands, an exact int32 accumulator, int32 out.  The reference leaves
its products to XLA (``lax.dot_general`` and ``lax.conv_general_dilated`` at
``preferred_element_type=int32``); integer sums are exact, so K1-int8 gives
the same int32 values.  On CPU tensors the wrapper runs its plain version.
Dequantisation and the bias stay in f32, in the reference's order:
``acc * (wscale * xscale)``, then ``+ b``.

K1-int8 on ``wgmma`` reads both operands K-major, so every weight table is
laid out once, at build time, as B^T: (out, in) for a Linear
(``linearOperand``), (groups, O / groups, K) for a conv (``convOperand``).
TMA reads rows of 16-byte multiples, so each table's K is padded with zeros
to a multiple of 16, and the activations' rows with it at each product:
zero columns against zero weights leave every int32 sum as it was.

The conv is an im2col product: x is quantized first, then the int8 values
are laid out channels-last, padded with zeros (quantize(0) = 0, so the
padding is the conv's own) and gathered into an (N * OH * OW, KH * KW * C)
int8 matrix by one strided slice per filter tap, one product per group.
The gather copies the int8 bytes themselves, never a float copy of them (the
library's ``unfold`` has no int8 kernel), 8, 4 or 2 channels at a time as
one wider integer where C allows: VGG-16's conv1_2 at batch 32 writes
1,605,632 x 576 bytes = 0.92 GB.  A conv product's K (taps * C / groups)
is padded in the gathered rows themselves (conv1_1's K = 27 runs as 32).
The output is the NCHW view of the channels-last product, as K2's is.
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


def _padK(k):
    """A product's K as K1-int8 takes it: a multiple of 16."""
    return -(-k // 16) * 16


def linearOperand(wq, transpose):
    """An int8 Linear table as K1-int8's operand B^T, (out, in): a
    transposed Linear's (out, in) table as it is, another's (in, out) one
    transposed, then zeros up to in's multiple of 16.  An engine lays it out
    once, at build time."""
    wq = torch.as_tensor(wq)
    wt = wq if transpose else wq.t()
    return F.pad(wt, (0, _padK(wt.shape[1]) - wt.shape[1])).contiguous()


def linearAcc(xq, wt):
    """The int32 products of the int8 Linear: ``xq`` int8 (M, in), ``wt``
    the table as ``linearOperand`` lays it out -> (M, out) int32, the rows
    of ``xq`` padded with zeros to the table's K."""
    k, kpad = xq.shape[1], wt.shape[1]
    if kpad > k:
        xq = F.pad(xq, (0, kpad - k))

    return _k1.matmulNT(xq, wt)


def quantLinear(x, wt, wscale, xscale, b):
    """y = dequant(int8(x) @ int8(w)) + b; wt is the (out, in) table as
    ``linearOperand`` lays it out; wscale holds one scale per output."""
    acc = linearAcc(_quantizeAct(x, xscale), wt)
    return _dequantize(acc, wscale, xscale, b)


def _outSize(size, k, stride, pad, dilation):
    return (size + 2 * pad - dilation * (k - 1) - 1) // stride + 1


def im2col(xq, ksize, stride, pad, dilation, kcols=None):
    """int8 NC* ``xq`` -> (N, *out, kcols) int8, channels last: for each
    filter tap (in row-major order over ``ksize``) the C values of the
    strided slice of the zero-padded input that the tap meets at every
    output position, then zeros up to ``kcols`` (taps * C by default)."""
    nd = xq.dim() - 2
    c = xq.shape[1]
    xl = xq.movedim(1, -1)

    ntaps = int(np.prod(ksize))
    kcols = ntaps * c if kcols is None else kcols

    padding = []
    for p in reversed(pad):
        padding += [p, p]

    # the gather moves 8, 4 or 2 channels as one wider element where C and
    # the row allow: the same bytes, in a fraction of the copies
    width = next(w for w in (8, 4, 2, 1) if c % w == 0 and kcols % w == 0)
    xl = F.pad(xl, [0, 0] + padding).contiguous().view(_WIDE[width])

    out = [_outSize(xq.shape[2 + i], ksize[i], stride[i], pad[i], dilation[i]) for i in range(nd)]

    taps = []
    for offsets in itertools.product(*[range(k) for k in ksize]):
        index = [slice(None)]
        for i, o in enumerate(offsets):
            start = o * dilation[i]
            index.append(slice(start, start + stride[i] * (out[i] - 1) + 1, stride[i]))

        taps.append(xl[tuple(index)])

    if kcols > ntaps * c:
        tail = taps[0].shape[:-1] + ((kcols - ntaps * c) // width, )
        taps.append(xl.new_zeros(()).expand(tail))

    return torch.cat(taps, dim=-1).view(torch.int8)


def convOperand(wq, groups):
    """An int8 conv table (O, C / groups, *k) as K1-int8's operands B^T:
    (groups, O / groups, K), K = taps * C / groups ordered (tap, channel) as
    ``im2col`` gathers, then zeros up to a multiple of 16.  An engine lays it
    out once, at build time."""
    o, cg = wq.shape[:2]
    taps = wq[0, 0].numel()
    k = taps * cg
    wmat = wq.reshape(groups, o // groups, cg, taps).transpose(2, 3).reshape(groups, o // groups, k)
    return F.pad(wmat, (0, _padK(k) - k)).contiguous()


def convAcc(xq, wmat, ksize, stride, pad, dilation):
    """The int32 products of the int8 conv: ``xq`` int8 NC*, ``wmat`` the
    table as ``convOperand`` lays it out, for a filter of ``ksize`` ->
    (N * prod(out), O) int32, rows in (N, *out) order.  One K1-int8 product
    per group, its rows padded with zeros to the table's K."""
    groups, _, kpad = wmat.shape
    c = xq.shape[1]
    taps = int(np.prod(ksize))
    k = taps * c // groups

    if groups == 1:
        cols = im2col(xq, ksize, stride, pad, dilation, kcols=kpad)   # (N, *out, kpad)
        return _k1.matmulNT(cols.reshape(-1, kpad), wmat[0])

    cols = im2col(xq, ksize, stride, pad, dilation)                  # (N, *out, taps * C)
    cols = cols.reshape(-1, taps, groups, c // groups)
    return torch.cat([
        _k1.matmulNT(F.pad(cols[:, :, g].reshape(-1, k), (0, kpad - k)).contiguous(), wmat[g])
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
