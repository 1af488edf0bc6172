"""DNN primitive dispatch (counterpart of ``puzzlelib_tpu/backend/dnn.py``):
the conv, pool and softmax slots of the VGG slices, forward and backward.

The parameter gradients are written in place into the variables' gradient
buffers (``_accumulateParamGrads``), which under an optimizer's global state
are views of its flat buffer."""

from enum import Enum

from puzzlelib_tpu_torch.ops import conv as _conv
from puzzlelib_tpu_torch.ops import pool as _pool
from puzzlelib_tpu_torch.ops import softmax as _softmax


class PoolMode(Enum):
    max = "max"


class SoftMaxMode(Enum):
    perActivation = "perActivation"
    spatial = "spatial"


def _t(v):
    return tuple(int(x) for x in v)


def convNd(data, W, bias, stride, pad, dilation, groups):
    return _conv.convNd(data, W, bias, _t(stride), _t(pad), _t(dilation), int(groups))


def convKernelLayout(data, W, stride, pad, dilation, groups):
    return _conv.kernelLayout(data, tuple(W.shape), _t(stride), _t(pad), _t(dilation), int(groups))


def convNdBackwardData(grad, W, data, stride, pad, dilation, groups):
    return _conv.convNdBackwardData(grad, W, tuple(data.shape), _t(stride), _t(pad), _t(dilation), int(groups))


def convNdBackwardParams(data, grad, W, bias, stride, pad, dilation, groups,
                         wgrad=None, bgrad=None, scale=1.0, momentum=0.0):
    dw, db = _conv.convNdBackwardParams(data, grad, W, _t(stride), _t(pad), _t(dilation), int(groups),
                                        hasBias=bias is not None)

    return _accumulateParamGrads(dw, db, bias, wgrad, bgrad, scale, momentum)


def _fold(new, acc, scale, momentum):
    """acc = new * scale + acc * momentum, written into ``acc``; a new tensor
    ``new * scale`` when there is no ``acc``."""
    if acc is None:
        return new * scale if scale != 1.0 else new

    return acc.copy_(new * scale + acc * momentum if momentum != 0.0 else new * scale)


def _accumulateParamGrads(dw, db, bias, wgrad, bgrad, scale, momentum):
    outw = _fold(dw, wgrad, scale, momentum)

    if db is None:
        return outw

    db = db.reshape(bias.shape if bias is not None else db.shape)
    return outw, _fold(db, bgrad, scale, momentum)


def poolNd(data, size, stride, pad, mode=PoolMode.max, test=False):
    """(pooled, workspace); the workspace is None, as in the reference."""
    return _pool.poolNd(data, _t(size), _t(stride), _t(pad), mode.value), None


def poolNdBackward(indata, outdata, grad, workspace, size, stride, pad, mode=PoolMode.max):
    return _pool.poolNdBackward(grad, indata, _t(size), _t(stride), _t(pad), mode.value)


def softmaxNd(data, mode=SoftMaxMode.spatial):
    return _softmax.softmaxNd(data)


def softmaxNdBackward(outdata, grad):
    return _softmax.softmaxNdBackward(outdata, grad)
