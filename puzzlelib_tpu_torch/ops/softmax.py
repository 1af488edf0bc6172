"""Softmax over the channel axis, computed in f32 (counterpart of
``puzzlelib_tpu/ops/softmax.py``)."""

import torch


def softmaxNd(x):
    return torch.softmax(x.float(), dim=1).to(x.dtype)
