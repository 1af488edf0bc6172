"""N-dimensional convolution in NCHW layout, forward and backward
(counterpart of ``puzzlelib_tpu/ops/conv.py``).

While ``Config.convAlgo`` is "hopper", a bf16 conv on CUDA tensors goes to a
hand-written kernel where one takes it, and everything else to the library
call, the counterpart of the reference's ``lax`` convs:

- forward: ``_convCore`` sends what ``winograd.applicable`` takes to K2,
  the rest to ``torch.nn.functional.conv{1,2,3}d``;
- bwd-data: the stride-1 transposed conv is a plain conv of the gradient
  with the rotated, io-swapped filter, so ``_transposedConv`` sends what
  ``_convCore``'s rule takes to K2 (``winograd.dataGrad``); the strided or
  dilated remainder goes to ``torch.nn.functional.conv_transpose{1,2,3}d``;
- bwd-filter: ``_filterGrad`` sends what ``winograd.filterGradApplicable``
  takes to K3 (``winograd.filterGrad``), the rest to the library's
  bwd-filter (``torch.nn.grad.conv{1,2,3}d_weight``).

The bias gradient is a sum in f32 cast back to the gradient's type, as in
the reference.
"""

import torch
import torch.nn.functional as F

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.ops.hopper import winograd


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_TRANSPOSE = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}
_CONV_WEIGHT = {1: torch.nn.grad.conv1d_weight, 2: torch.nn.grad.conv2d_weight, 3: torch.nn.grad.conv3d_weight}


def _onHopper(*tensors):
    return (tensors[0].dim() == 4 and tensors[0].is_cuda and Config.useHopper(Config.convAlgo)
            and all(t.dtype == torch.bfloat16 for t in tensors))


def _useWinograd(x, wshape, stride, pad, dilation, groups):
    return _onHopper(x) and winograd.applicable(tuple(x.shape), tuple(wshape), stride, pad, dilation, groups)


def _convCore(x, w, stride, pad, dilation, groups):
    if w.dtype == x.dtype and _useWinograd(x, w.shape, stride, pad, dilation, groups):
        return winograd.conv2d(x, w, pad)

    return _CONV[x.dim() - 2](x, w, stride=stride, padding=pad, dilation=dilation, groups=groups)


def kernelLayout(x, wshape, stride, pad, dilation, groups):
    """x in the memory layout that the conv's kernels read: channels-last
    where K2 takes the conv, so that its forward and K3 on the same input copy
    nothing; else x as it is."""
    if _useWinograd(x, wshape, stride, pad, dilation, groups):
        return x.contiguous(memory_format=torch.channels_last)

    return x


def convNd(x, w, b, stride, pad, dilation, groups):
    out = _convCore(x, w, stride, pad, dilation, groups)

    if b is not None:
        out = out + b.reshape((1, b.numel()) + (1, ) * (x.dim() - 2)).to(out.dtype)

    return out


# -- bwd-filter ------------------------------------------------------------------

def _filterGrad(x, grad, wshape, stride, pad, dilation, groups):
    """dW (outmaps, inmaps // groups, *size) of the forward conv."""
    if _onHopper(x, grad) and winograd.filterGradApplicable(tuple(x.shape), tuple(grad.shape), stride, pad,
                                                            dilation, groups):
        return winograd.filterGrad(x, grad, pad)

    return _CONV_WEIGHT[x.dim() - 2](x, wshape, grad, stride=stride, padding=pad, dilation=dilation,
                                     groups=groups)


def _biasGrad(grad):
    axes = (0, ) + tuple(range(2, grad.dim()))
    return grad.float().sum(dim=axes).to(grad.dtype)


def convNdBackwardParams(x, grad, w, stride, pad, dilation, groups, hasBias=False):
    """(dW in w's type, db in grad's type or None)."""
    dw = _filterGrad(x, grad, tuple(w.shape), stride, pad, dilation, groups).to(w.dtype)
    return dw, _biasGrad(grad) if hasBias else None


# -- bwd-data --------------------------------------------------------------------

def _transposedConv(y, w, stride, pad, dilation, adj, groups):
    """Map y (N, outmaps, *yspatial) back through the forward conv's kernel
    w (outmaps, inmaps // groups, *size).  ``adj`` is the extra high padding
    per axis that recovers the sizes lost to the stride's flooring."""
    nd = y.dim() - 2
    size = tuple(w.shape[2:])

    # the stride-1 transposed conv IS a plain conv of y with the flipped,
    # io-swapped kernel: K2 where _convCore's rule takes that conv, else the
    # library's plain conv
    if (all(s == 1 for s in stride) and all(a == 0 for a in adj) and groups == 1
            and all(dilation[i] * (size[i] - 1) >= pad[i] for i in range(nd))):
        padT = tuple(dilation[i] * (size[i] - 1) - pad[i] for i in range(nd))

        if w.dtype == y.dtype and _useWinograd(y, (w.shape[1], w.shape[0]) + size, (1, ) * nd, padT, dilation, 1):
            return winograd.dataGrad(y, w, pad)

        wT = torch.flip(w, tuple(range(2, 2 + nd))).transpose(0, 1)
        return _CONV[nd](y, wT, padding=padT, dilation=dilation)

    return _CONV_TRANSPOSE[nd](y, w, stride=stride, padding=pad, output_padding=adj, groups=groups,
                               dilation=dilation)


def _strideAdjust(inspatial, size, stride, pad, dilation):
    """Per-axis remainder lost by the forward conv's stride flooring."""
    return tuple(
        inspatial[i] + 2 * pad[i] - (dilation[i] * (size[i] - 1) + 1)
        - stride[i] * ((inspatial[i] + 2 * pad[i] - dilation[i] * (size[i] - 1) - 1) // stride[i])
        for i in range(len(size))
    )


def convNdBackwardData(grad, w, xshape, stride, pad, dilation, groups):
    adj = _strideAdjust(xshape[2:], tuple(w.shape[2:]), stride, pad, dilation)
    return _transposedConv(grad, w, stride, pad, dilation, adj, groups).to(grad.dtype)
