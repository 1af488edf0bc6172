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


def _onehot(labels, ncases, like):
    """(batch, classes, *spatial) bool: labels (batch, *spatial) against the
    class axis."""
    classes = torch.arange(ncases, device=labels.device).reshape((1, ncases) + (1, ) * (like.dim() - 2))
    return labels.long().unsqueeze(1) == classes


def svm(scores, labels, mode="l1"):
    """One-vs-rest SVM: scores (batch, classes, *spatial) raw, labels
    (batch, *spatial) int, each class's target +1 for the label and -1 for
    the rest -> (err, grad), the margins 1 - score * target in f32.  "l1":
    err = sum(max(margin, 0)) / classes / spatial, grad = target / classes /
    batch where the margin is positive; "l2" squares the hinge: err =
    sum(hinge^2) / classes / spatial, grad = 2 target hinge / classes /
    batch.  The gradient in the scores' type."""
    batch, ncases = scores.shape[:2]
    spatial = int(np.prod(scores.shape[2:])) if scores.dim() > 2 else 1

    cls = torch.where(_onehot(labels, ncases, scores), 1.0, -1.0)
    margin = 1.0 - scores.float() * cls

    if mode == "l1":
        grad = torch.where(margin > 0, cls / ncases / batch, 0.0)
        err = torch.clamp(margin, min=0.0).sum() / ncases / spatial
    else:
        hinge = torch.clamp(margin, min=0.0)
        grad = 2.0 * cls * hinge / ncases / batch
        err = (hinge * hinge).sum() / ncases / spatial

    return err, grad.to(scores.dtype)


def hinge(scores, labels):
    """Elementwise hinge against +-1 labels of the scores' shape -> (err,
    grad): err = sum(max(0, 1 - score * label)) / cells per sample, grad =
    label / batch / cells where score * label < 1, in f32, the gradient cast
    to the scores' type."""
    batch = scores.shape[0]
    ncases = int(np.prod(scores.shape[1:])) if scores.dim() > 1 else 1

    prod = scores.float() * labels.float()

    err = torch.clamp(1.0 - prod, min=0.0).sum() / ncases
    grad = torch.where(prod < 1.0, labels.float() / batch / ncases, 0.0)

    return err, grad.to(scores.dtype)


def smoothL1(pred, target, norm, fullnorm):
    """Smooth L1 (Huber at 1) -> (err, grad): err = sum(diff^2 / 2 where
    |diff| < 1, else |diff| - 0.5) * norm, grad = diff * fullnorm where
    |diff| < 1, else sign(diff) * fullnorm; diff = pred - target in f32, the
    gradient cast to the prediction's type."""
    diff = pred.float() - target.float()
    sign = torch.where(diff > 0, 1.0, -1.0)
    absd = diff * sign

    err = torch.where(absd < 1.0, diff * diff / 2.0 * norm, (absd - 0.5) * norm).sum()
    grad = torch.where(absd < 1.0, diff * fullnorm, sign * fullnorm)

    return err, grad.to(pred.dtype)


def l1Hinge(x1, x2, labels):
    """Pairwise L1 hinge of embeddings x1, x2 (batch, ...) with labels
    (batch, ) 1 (similar) or 0 (dissimilar) -> (err, g1, g2): a similar
    pair costs |x1 - x2|, a dissimilar one max(0, 1 - |x1 - x2|), cell by
    cell, summed and divided by the cells per sample; g1 the descent
    direction for x1 over batch and cells, g2 = -g1, each in its input's
    type."""
    batch = x1.shape[0]
    ncases = int(np.prod(x1.shape[1:])) if x1.dim() > 1 else 1

    d = x1.float() - x2.float()
    sign = torch.where(d > 0, 1.0, -1.0)
    absd = d * sign

    isDissim = labels.reshape((batch, ) + (1, ) * (x1.dim() - 1)) == 0

    err = torch.where(isDissim, torch.clamp(1.0 - absd, min=0.0), absd).sum() / ncases
    g1 = torch.where(isDissim, (absd < 1.0).float() * -sign, sign) / batch / ncases

    return err, g1.to(x1.dtype), (-g1).to(x2.dtype)


def kldiv(pred, target, normTarget):
    """KL divergence of the softmax of pred (over axis 1) from the target
    distribution (itself softmaxed with ``normTarget``) -> (err, grad): err =
    sum(t (log t - log p)) / batch, grad = (t - p) / batch, in f32, the
    gradient cast to the prediction's type."""
    batch = pred.shape[0]
    p = torch.softmax(pred.float(), dim=1)
    t = torch.softmax(target.float(), dim=1) if normTarget else target.float()

    err = (t * (torch.log(torch.clamp(t, min=1e-38)) - torch.log(torch.clamp(p, min=1e-38)))).sum() / batch
    grad = (t - p) / batch

    return err, grad.to(pred.dtype)


def abscost(pred, target):
    """Mean absolute error -> (err, grad): err = sum|pred - target| / cells
    per sample in f32, grad = -1 / size where pred > target, else 1 / size,
    size the number of target cells, in the prediction's type."""
    norm = 1.0 / int(np.prod(target.shape))
    ncases = int(np.prod(target.shape[1:])) if target.dim() > 1 else 1

    diff = pred.float() - target.float()
    err = diff.abs().sum() / ncases
    grad = torch.where(diff > 0, -norm, norm)

    return err, grad.to(pred.dtype)
