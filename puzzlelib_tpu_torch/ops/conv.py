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
  dilated remainder goes to ``torch.nn.functional.conv_transpose{1,2,3}d``,
  and so does a gradient narrower than the kernel along an axis
  (``_narrowerThanKernel``), which the plain conv would pad by nearly the
  kernel's width on both sides (SentiNet's filters span the embedding, so
  its gradient has one column: 608 ms a call against 0.56 on an H100);
- bwd-filter: ``_filterGrad`` sends what ``winograd.filterGradApplicable``
  takes to K3 (``winograd.filterGrad``), the rest to the library's
  bwd-filter (``torch.nn.grad.conv{1,2,3}d_weight``).  A 1-d one, and one
  whose output is narrower than its kernel (a 1-d conv in effect), takes
  cuDNN's deterministic algorithms, as does the transposed conv of such a
  gradient, so that each repeats bit for bit: the heuristic's picks for
  them add with atomics.

The deconvolution (transposed conv, cuDNN-style: its forward is the conv's
bwd-data) reuses the three: ``deconvNd`` is ``_transposedConv`` with
``postpad`` as the stride adjustment, so a stride-1 3x3 deconv whose
channels are multiples of 128 goes to K2 through ``winograd.dataGrad``; its
bwd-data is ``_convCore`` (K2 where it takes the conv); its bwd-filter is
``_filterGrad`` with the roles of input and gradient swapped (K3 where it
takes it).  U-Net's 2x2 stride-2 deconvs go to
``torch.nn.functional.conv_transpose2d`` and the library's bwd-filter.

The bias gradient is a sum in f32 cast back to the gradient's type, as in
the reference.
"""

import contextlib

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


def _narrowerThanKernel(spatial, size, dilation):
    """True where ``spatial`` (a conv's output extent) has fewer cells
    along an axis than the dilated kernel spans."""
    return any(n < d * (k - 1) + 1 for n, k, d in zip(spatial, size, dilation))


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

@contextlib.contextmanager
def _cudnnDeterministic():
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def _filterGrad(x, grad, wshape, stride, pad, dilation, groups):
    """dW (outmaps, inmaps // groups, *size) of the forward conv.  A 1-d
    conv's library bwd-filter, and that of a conv whose output is narrower
    than its kernel, takes cuDNN's deterministic algorithms: the ones its
    heuristic picks for the IMDB CNN's and SentiNet's f32 convs add with
    atomics and gave other bits at each call on an H100."""
    if _onHopper(x, grad) and winograd.filterGradApplicable(tuple(x.shape), tuple(grad.shape), stride, pad,
                                                            dilation, groups):
        return winograd.filterGrad(x, grad, pad)

    nd = x.dim() - 2
    deterministic = nd == 1 or _narrowerThanKernel(tuple(grad.shape[2:]), wshape[2:], dilation)
    with _cudnnDeterministic() if deterministic else contextlib.nullcontext():
        return _CONV_WEIGHT[nd](x, wshape, grad, stride=stride, padding=pad, dilation=dilation, groups=groups)


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
    # library's plain conv, unless y is narrower than the kernel
    narrow = _narrowerThanKernel(tuple(y.shape[2:]), size, dilation)
    if (all(s == 1 for s in stride) and all(a == 0 for a in adj) and groups == 1
            and all(dilation[i] * (size[i] - 1) >= pad[i] for i in range(nd))):
        padT = tuple(dilation[i] * (size[i] - 1) - pad[i] for i in range(nd))

        if w.dtype == y.dtype and _useWinograd(y, (w.shape[1], w.shape[0]) + size, (1, ) * nd, padT, dilation, 1):
            return winograd.dataGrad(y, w, pad)

        if not narrow:
            wT = torch.flip(w, tuple(range(2, 2 + nd))).transpose(0, 1)
            return _CONV[nd](y, wT, padding=padT, dilation=dilation)

    with _cudnnDeterministic() if narrow else contextlib.nullcontext():
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


# -- deconvolution ---------------------------------------------------------------

def deconvNd(x, w, b, stride, pad, dilation, postpad, groups):
    """The transposed conv of x (N, inmaps, *spatial) with w (inmaps, outmaps
    // groups, *size), the forward conv kernel of the reverse direction, plus
    the bias."""
    out = _transposedConv(x, w, stride, pad, dilation, postpad, groups).to(x.dtype)

    if b is not None:
        out = out + b.reshape((1, b.numel()) + (1, ) * (x.dim() - 2)).to(out.dtype)

    return out


def deconvNdBackwardData(grad, w, stride, pad, dilation, groups):
    """The deconv's input gradient: the plain forward conv of grad with w,
    which is (O = inmaps, I = outmaps // groups) for that direction."""
    return _convCore(grad, w, stride, pad, dilation, groups)


def deconvNdBackwardParams(x, grad, w, stride, pad, dilation, groups, hasBias=False):
    """(dW in w's type, db in grad's type or None): the deconv is the conv
    that maps grad's space to x's, so dW is that conv's filter gradient."""
    dw = _filterGrad(grad, x, tuple(w.shape), stride, pad, dilation, groups).to(w.dtype)
    return dw, _biasGrad(grad) if hasBias else None
