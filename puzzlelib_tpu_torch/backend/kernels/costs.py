"""Cost kernel dispatch (counterpart of
``puzzlelib_tpu/backend/kernels/costs.py``): the fused cost ops of
``ops.cost`` and ``ops.ctc`` behind the reference's kernel names.  An
``error`` given to a kernel is a 0-d f32 tensor that it writes (the two
``*Kernel`` functions) or adds its batch's error to (the ``*Ker``
functions, which also write their gradients into the buffers given)."""

import torch

from puzzlelib_tpu_torch.ops import cost as _cost
from puzzlelib_tpu_torch.ops import ctc as _ctc


def _errorTensor(error, like):
    return torch.zeros((), dtype=torch.float32, device=like.device) if error is None else error


def crossEntropyKernel(scores, labels, weights=None, error=None):
    err, grad = _cost.crossEntropy(scores, labels, weights)

    error = _errorTensor(error, scores)
    error.copy_(err)
    return error, grad


def svmKernel(scores, labels, mode="l1", error=None):
    err, grad = _cost.svm(scores, labels, mode=mode)

    error = _errorTensor(error, scores)
    error.copy_(err)
    return error, grad


def bceKer(scores, labels, error, grad, numsamples=None, spatialDim=None):
    err, g = _cost.bce(scores, labels)
    error.add_(err)
    grad.copy_(g)
    return error, grad


def hingeKer(scores, labels, error, grad, numsamples=None, numcases=None):
    err, g = _cost.hinge(scores, labels)
    error.add_(err)
    grad.copy_(g)
    return error, grad


def smoothL1Ker(pred, target, error, grad, norm, fullnorm):
    err, g = _cost.smoothL1(pred, target, norm, fullnorm)
    error.add_(err)
    grad.copy_(g)
    return error, grad


def l1HingeKer(x1, x2, labels, error, g1, g2, numsamples=None, numcases=None):
    err, grad1, grad2 = _cost.l1Hinge(x1, x2, labels)
    error.add_(err)
    g1.copy_(grad1)
    g2.copy_(grad2)
    return error, g1, g2


def _calcAccuracy(pred, labels, allocator=None):
    return _cost.accuracy(pred, labels)


def _calcBCEAccuracy(scores, labels, allocator=None):
    return _cost.signMisses(scores, labels)


def _l1HingeAccuracy(dist, labels, allocator=None):
    """The pairs whose distance (within 1: similar) misses their 0 / 1
    label, as a 0-d f32 tensor."""
    return ((dist <= 1.0) != labels.bool()).sum().float()


def _klDivergence(softmax, target, grad, gradnorm, allocator=None):
    """Writes (target - softmax) * gradnorm into ``grad``; returns sum(t (log
    t - log p)) over the cells whose target is positive, as a 0-d f32
    tensor.  The two are paired cell by cell in flat order."""
    x = softmax.float().reshape(grad.shape)
    y = target.float().reshape(grad.shape)

    grad.copy_(((y - x) * gradnorm).to(grad.dtype))

    terms = y * (torch.log(torch.clamp(y, min=1e-38)) - torch.log(torch.clamp(x, min=1e-38)))
    return torch.where(y > 0.0, terms, 0.0).sum()


def getAccuracyKernel(name):
    return {
        "calcAccuracy": _calcAccuracy,
        "calcBCEAccuracy": _calcBCEAccuracy,
        "l1HingeAccuracy": _l1HingeAccuracy,
        "klDivergence": _klDivergence,
    }[name]


def ctcLoss(data, datalen, labels, lengths, blank, error=None, normalized=False):
    """(error, grad) of ``ops.ctc.ctcLoss``; the error is written into
    ``error`` (a 0-d f32 tensor) when it is given."""
    err, grad = _ctc.ctcLoss(data, datalen, labels, lengths, blank, normalized)

    error = _errorTensor(error, data)
    error.copy_(err)
    return error, grad


def ctcLossTest(data, datalen, labels, lengths, blank):
    return _ctc.hostCTCLoss(data, datalen, labels, lengths, blank)
