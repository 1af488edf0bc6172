"""PRelu (counterpart of ``puzzlelib_tpu/backend/kernels/prelu.py``): one
negative slope a map, or one for every map (``sharedMaps``).  The slopes'
gradient sums x * grad over the cells where x <= 0 in f32 and rounds once
to the gradient's type, as the reference does."""

import torch


def _slopes(slopes, ndim, sharedMaps, dtype):
    shape = (1, ) * ndim if sharedMaps else (1, slopes.numel()) + (1, ) * (ndim - 2)
    return slopes.reshape(shape).to(dtype)


def prelu(data, slopes, sharedMaps=False):
    return torch.where(data > 0, data, data * _slopes(slopes, data.dim(), sharedMaps, data.dtype))


def preluBackwardData(grad, slopes, indata, sharedMaps=False):
    a = _slopes(slopes, indata.dim(), sharedMaps, grad.dtype)
    return grad * torch.where(indata > 0, torch.ones((), dtype=grad.dtype, device=grad.device), a)


def preluBackwardParams(indata, outgrad, sharedMaps=False):
    contrib = torch.where(indata > 0, 0.0, indata.float() * outgrad.float())

    if sharedMaps:
        return contrib.sum().reshape(1).to(outgrad.dtype)

    return contrib.sum(dim=(0, ) + tuple(range(2, indata.dim()))).to(outgrad.dtype)
