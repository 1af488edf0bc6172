"""Fused cost ops (counterpart of ``puzzlelib_tpu/ops/cost.py``): each
returns (error on the device, descent-direction gradient).  Gradients point
downhill (the optimizers add their updates); the error is normalised by the
spatial extent only (the Cost divides by the batch when it is read) and the
gradient by the batch."""

import numpy as np
import torch


def crossEntropy(scores, labels):
    """scores (batch, classes, *spatial) raw, labels (batch, *spatial) int ->
    (err, grad): err = sum(-log softmax[label]) / spatial in f32, a 0-d
    tensor; grad = (onehot - softmax) / batch in the scores' type.  The
    softmax is taken in f32."""
    batch, ncases = scores.shape[:2]
    spatial = int(np.prod(scores.shape[2:])) if scores.dim() > 2 else 1

    p = torch.softmax(scores.float(), dim=1)
    onehot = torch.zeros_like(p).scatter_(1, labels.long().unsqueeze(1), 1.0)

    grad = ((onehot - p) / batch).to(scores.dtype)
    err = -torch.log(torch.clamp((p * onehot).sum(dim=1), min=1e-38)).sum() / spatial

    return err, grad
