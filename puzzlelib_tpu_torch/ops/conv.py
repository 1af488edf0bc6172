"""N-dimensional convolution in NCHW layout, forward
(counterpart of ``puzzlelib_tpu/ops/conv.py``).

``_convCore`` sends a bf16 conv on CUDA tensors that the Winograd kernel
takes (``winograd.applicable``) to kernel K2 while ``Config.convAlgo`` is
"hopper"; every other conv goes to ``torch.nn.functional.conv{1,2,3}d``, the
counterpart of the reference's ``lax.conv_general_dilated``.  The backward
passes come with training.
"""

import torch
import torch.nn.functional as F

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.ops.hopper import winograd


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _useWinograd(x, w, stride, pad, dilation, groups):
    return (x.dim() == 4 and x.is_cuda and Config.useHopper(Config.convAlgo)
            and x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
            and winograd.applicable(tuple(x.shape), tuple(w.shape), stride, pad, dilation, groups))


def _convCore(x, w, stride, pad, dilation, groups):
    if _useWinograd(x, w, stride, pad, dilation, groups):
        return winograd.conv2d(x, w, pad)

    return _CONV[x.dim() - 2](x, w, stride=stride, padding=pad, dilation=dilation, groups=groups)


def convNd(x, w, b, stride, pad, dilation, groups):
    out = _convCore(x, w, stride, pad, dilation, groups)

    if b is not None:
        out = out + b.reshape((1, b.numel()) + (1, ) * (x.dim() - 2)).to(out.dtype)

    return out
