"""Fused cost ops (counterpart of ``puzzlelib_tpu/ops/cost.py``): each
returns (error on the device, descent-direction gradient).  Gradients point
downhill (the optimizers add their updates); the error is normalised by the
spatial extent only (the Cost divides by the batch when it is read) and the
gradient by the batch."""

import numpy as np
import torch


def crossEntropy(scores, labels, weights=None):
    """scores (batch, classes, *spatial) raw, labels (batch, *spatial) int,
    optional per-class ``weights`` (classes, ) -> (err, grad): err =
    sum(-w[label] * log softmax[label]) / spatial in f32, a 0-d tensor; grad
    = w[class] * (onehot - softmax) / batch in the scores' type.  The softmax
    and the weights are taken in f32."""
    batch, ncases = scores.shape[:2]
    spatial = int(np.prod(scores.shape[2:])) if scores.dim() > 2 else 1

    p = torch.softmax(scores.float(), dim=1)
    onehot = torch.zeros_like(p).scatter_(1, labels.long().unsqueeze(1), 1.0)
    logp = torch.log(torch.clamp((p * onehot).sum(dim=1), min=1e-38))

    if weights is None:
        return -logp.sum() / spatial, ((onehot - p) / batch).to(scores.dtype)

    w = weights.float().reshape((1, ncases) + (1, ) * (scores.dim() - 2))
    grad = (w * (onehot - p) / batch).to(scores.dtype)
    err = -((w * onehot).sum(dim=1) * logp).sum() / spatial

    return err, grad


def accuracy(pred, labels):
    """The number of predictions that miss their labels, as a 0-d f32
    tensor (the reference's name for it)."""
    return (pred != labels).sum().float()


def bce(scores, labels):
    """Binary cross-entropy of logit scores (any shape, batch first) against
    {0, 1} labels paired with them cell by cell in flat order -> (err, grad):
    the sigmoid fused in, err = sum(-log p or -log(1 - p)) / size per sample
    in f32 (a 0-d tensor), grad = (label - p) / batch / size in f32, cast to
    the scores' type."""
    batch = scores.shape[0]
    spatial = int(np.prod(scores.shape[1:])) if scores.dim() > 1 else 1

    prob = torch.sigmoid(scores.float().reshape(-1))
    isOne = labels.reshape(-1) == 1

    err = torch.where(isOne, -torch.log(torch.clamp(prob, min=1e-38)),
                      -torch.log(torch.clamp(1.0 - prob, min=1e-38))).sum() / spatial
    grad = (isOne.float() - prob) / batch / spatial

    return err, grad.reshape(scores.shape).to(scores.dtype)


def signMisses(scores, labels):
    """The number of logit scores whose sign misses their {0, 1} label
    (label 1 with a score <= 0, label 0 with a score > 0), as a 0-d f32
    tensor."""
    x, y = scores.reshape(-1), labels.reshape(-1)
    return torch.where(y == 1, x <= 0, x > 0).sum().float()
