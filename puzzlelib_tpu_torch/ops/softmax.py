"""Softmax over the channel axis and its backward, computed in f32
(counterpart of ``puzzlelib_tpu/ops/softmax.py``)."""

import torch


def softmaxNd(x):
    return torch.softmax(x.float(), dim=1).to(x.dtype)


def softmaxNdBackward(out, grad):
    """The input gradient from the softmax's output and output gradient."""
    of, gf = out.float(), grad.float()
    return (of * (gf - (gf * of).sum(dim=1, keepdim=True))).to(out.dtype)
