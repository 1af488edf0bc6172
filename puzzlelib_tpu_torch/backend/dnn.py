"""DNN primitive dispatch (counterpart of ``puzzlelib_tpu/backend/dnn.py``):
the conv, deconv, pool, softmax, batch-norm, instance-norm, LRN and
spatial-transformer slots, forward and backward, ``convNdbenchmark``, which times a conv's or a deconv's three
directions, and the RNN entries over ``backend/rnn.py``.  The RNN's backward
is one entry, ``backwardRnn``, which gives the input's and the weights'
gradients of one recompute together, where the reference has two entries
that share the output gradient through a side channel.

The parameter gradients are written in place into the variables' gradient
buffers (``_accumulateParamGrads``), which under an optimizer's global state
are views of its flat buffer."""

from enum import Enum

import numpy as np
import torch

from puzzlelib_tpu_torch.backend import gpuarray
from puzzlelib_tpu_torch.backend.device import getDevice, timeKernel
from puzzlelib_tpu_torch.ops import conv as _conv
from puzzlelib_tpu_torch.ops import norm as _norm
from puzzlelib_tpu_torch.ops import pool as _pool
from puzzlelib_tpu_torch.ops import softmax as _softmax
from puzzlelib_tpu_torch.ops import spatialtf as _spatialtf


class ConvFwdAlgo(Enum):
    """The reference's (cuDNN's) algorithm names.  The port reports
    ``winograd`` for a direction that ran a Winograd kernel (K2 or K3) and
    ``auto`` for one that went to the library call."""
    auto = 0
    implicitGemm = 1
    implicitPrecompGemm = 2
    gemm = 3
    direct = 4
    fft = 5
    fftTiling = 6
    winograd = 7
    winogradNonfused = 8


class ConvBwdDataAlgo(Enum):
    auto = -1
    algo0 = 0
    algo1 = 1
    fft = 2
    fftTiling = 3
    winograd = 4
    winogradNonfused = 5


class ConvBwdFilterAlgo(Enum):
    auto = -1
    algo0 = 0
    algo1 = 1
    fft = 2
    algo3 = 3
    winogradNonfused = 5
    fftTiling = 6


class ConvPerf:
    def __init__(self, algo, tm, memory=0, determinism=True, mathType=None):
        self.algo = algo
        self.time = tm
        self.memory = memory
        self.determinism = determinism
        self.mathType = mathType

    def toString(self):
        return "%-40s %-25s %-28s" % (
            "Algo %s" % self.algo, "time %.6f secs" % self.time, "memory %.6f mbytes" % (self.memory / 1024**2)
        )


class PoolMode(Enum):
    max = "max"
    avgWithPad = "avgWithPad"
    avgNoPad = "avgNoPad"
    maxDeterminism = "max"


class BatchNormMode(Enum):
    perActivation = "perActivation"
    spatial = "spatial"


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


def deconvNd(data, W, bias, stride, pad, dilation, postpad, groups):
    return _conv.deconvNd(data, W, bias, _t(stride), _t(pad), _t(dilation), _t(postpad), int(groups))


def deconvNdBackwardData(grad, W, data, stride, pad, dilation, groups):
    return _conv.deconvNdBackwardData(grad, W, _t(stride), _t(pad), _t(dilation), int(groups))


def deconvNdBackwardParams(data, grad, W, bias, stride, pad, dilation, groups,
                           wgrad=None, bgrad=None, scale=1.0, momentum=0.0):
    dw, db = _conv.deconvNdBackwardParams(data, grad, W, _t(stride), _t(pad), _t(dilation), int(groups),
                                          hasBias=bias is not None)

    return _accumulateParamGrads(dw, db, bias, wgrad, bgrad, scale, momentum)


def convNdbenchmark(datashape, Wshape, stride, pad, dilation, groups, transpose=False, dtype=np.float32):
    """Time a conv's forward, bwd-filter and bwd-data on the configured
    device, each on the route ``Config.convAlgo`` selects (K2 and K3 where
    they take the conv, the library's call elsewhere): ``(fwd, bwdFilter,
    bwdData)``, one ``ConvPerf`` list each, seconds of one call by
    ``timeKernel`` (25 calls after a warm-up), as the reference returns them.
    With ``transpose`` the three are the deconvolution's, whose output has
    ``datashape`` and whose weights ``Wshape`` (inmaps, outmaps // groups,
    *size), as ``DeconvND.optimizeForShape`` passes them.  ``dtype`` is a
    numpy or torch type ("bfloat16" by name).  A 2-d conv that is not
    transposed is first raced (``ops.conv.measureAlgoChoice``: each hand
    kernel that takes it against its library call, the faster recorded for
    ``Config.convAlgo = "auto"``), as the reference's is, so that the times
    are those of the route a net optimized for the shape runs."""
    from puzzlelib_tpu_torch.ops.hopper import winograd

    stride, pad, dilation, groups = _t(stride), _t(pad), _t(dilation), int(groups)
    dtype = torch.bfloat16 if isinstance(dtype, str) and dtype == "bfloat16" else gpuarray.toTorchDtype(dtype)
    device = getDevice()

    if not transpose and len(datashape) == 4:
        _conv.measureAlgoChoice(datashape, Wshape, stride, pad, dilation, groups, dtype=dtype)

    x = torch.zeros(tuple(datashape), dtype=dtype, device=device)
    w = torch.zeros(tuple(Wshape), dtype=dtype, device=device)

    if transpose:
        # x is the deconv's output, y = conv(x) its input
        y = _conv.deconvNdBackwardData(x, w, stride, pad, dilation, groups)
        postpad = _conv._strideAdjust(tuple(datashape[2:]), tuple(w.shape[2:]), stride, pad, dilation)

        def fwd():
            return _conv.deconvNd(y, w, None, stride, pad, dilation, postpad, groups)

        def bwdParams():
            return _conv.deconvNdBackwardParams(y, x, w, stride, pad, dilation, groups)

        def bwdData():
            return _conv.deconvNdBackwardData(x, w, stride, pad, dilation, groups)

    else:
        x = _conv.kernelLayout(x, tuple(w.shape), stride, pad, dilation, groups)

        def fwd():
            return _conv.convNd(x, w, None, stride, pad, dilation, groups)

        grad = fwd()

        def bwdParams():
            return _conv.convNdBackwardParams(x, grad, w, stride, pad, dilation, groups)

        def bwdData():
            return _conv.convNdBackwardData(grad, w, tuple(x.shape), stride, pad, dilation, groups)

    results = []
    for fn, counter in ((fwd, "launches"), (bwdParams, "filterGradLaunches"), (bwdData, "launches")):
        before = getattr(winograd, counter)
        secs = timeKernel(fn, looplength=25, log=False, normalize=True)
        algo = ConvFwdAlgo.winograd if getattr(winograd, counter) > before else ConvFwdAlgo.auto
        results.append([ConvPerf(algo, secs)])

    fwdRes, bwdParamsRes, bwdDataRes = results
    return fwdRes, bwdParamsRes, bwdDataRes


def poolNd(data, size, stride, pad, mode=PoolMode.max, test=False):
    """(pooled, workspace); the workspace is None, as in the reference."""
    return _pool.poolNd(data, _t(size), _t(stride), _t(pad), mode.value), None


def poolNdBackward(indata, outdata, grad, workspace, size, stride, pad, mode=PoolMode.max):
    return _pool.poolNdBackward(grad, indata, _t(size), _t(stride), _t(pad), mode.value)


def softmaxNd(data, mode=SoftMaxMode.spatial):
    return _softmax.softmaxNd(data)


def softmaxNdBackward(outdata, grad):
    return _softmax.softmaxNdBackward(outdata, grad)


def batchNormNd(data, scale, bias, mean, var, epsilon, factor, test, mode=BatchNormMode.spatial, out=None):
    """Test: the output normalized by the running stats (written into
    ``out`` when given).  Train: (output, saved mean, saved invstd), the
    saved stats shaped as ``scale``; ``mean`` and ``var`` are blended with
    ``factor`` (a number or a 0-d device tensor) in place."""
    if test:
        result = _norm.batchNormTest(data, scale, bias, mean, var, epsilon, mode=mode.value)

        if out is None:
            return result

        return out.copy_(result)

    outdata, savemean, saveinvvar = _norm.batchNormTrain(data, scale, bias, mean, var, epsilon, factor,
                                                         mode=mode.value)
    return outdata, savemean.reshape(scale.shape), saveinvvar.reshape(scale.shape)


def batchNormNdBackward(data, grad, scale, savemean, saveinvvar, epsilon, mode=BatchNormMode.spatial):
    ingrad, scalegrad, bgrad = _norm.batchNormBackward(grad, data, scale, savemean, saveinvvar, epsilon,
                                                       mode=mode.value)
    return ingrad, scalegrad.reshape(scale.shape), bgrad.reshape(scale.shape)


def instanceNorm2d(data, scale, bias, epsilon=1e-5):
    """(output, saved mean, saved invstd, the scale tiled over the batch)."""
    return _norm.instanceNorm2d(data, scale, bias, epsilon)


def instanceNorm2dBackward(grad, data, extscale, savemean, saveinvvar, epsilon, affine=True):
    return _norm.instanceNorm2dBackward(grad, data, extscale, savemean, saveinvvar, epsilon, affine=affine)


# -- LRN -----------------------------------------------------------------------
# The workspace is the denominator d (f32) that the backward reads again; in
# test mode there is none, as in the reference.

def mapLRN(data, means, N, alpha, beta, K, test=False):
    """(output, workspace): the LRN over each map's N x N windows, or, with
    ``means``, the divisive normalization of data - means."""
    if means is None:
        outdata, denom = _norm.mapLRN(data, int(N), alpha, beta, K)
    else:
        outdata, denom = _norm.divNorm(data, means, int(N), alpha, beta, K)

    return outdata, None if test else denom


def mapLRNBackward(data, outdata, grad, means, workspace, N, alpha, beta, K):
    """The data gradient; with ``means``, (data gradient, means gradient)."""
    if means is None:
        return _norm.mapLRNBackward(data, grad, workspace, int(N), alpha, beta)

    return _norm.divNormBackward(data, means, grad, workspace, int(N), alpha, beta)


def crossMapLRN(data, N, alpha, beta, K, test=False):
    outdata, denom = _norm.crossMapLRN(data, int(N), alpha, beta, K)
    return outdata, None if test else denom


def crossMapLRNBackward(data, outdata, grad, workspace, N, alpha, beta, K):
    return _norm.crossMapLRNBackward(data, grad, workspace, int(N), alpha, beta)


# -- spatial transformer ---------------------------------------------------------

def spatialTf(data, transform, outshape, getGrid):
    """The sampled output, and with ``getGrid`` its grid as well."""
    outdata, grid = _spatialtf.spatialTf(data, transform, outshape)
    return (outdata, grid) if getGrid else outdata


def spatialTfBackward(grad, data, grid):
    """(data gradient, transform gradient)."""
    return _spatialtf.spatialTfBackward(grad, data, grid)


class RNNMode(Enum):
    relu = "relu"
    tanh = "tanh"
    lstm = "lstm"
    gru = "gru"


class DirectionMode(Enum):
    uni = "uni"
    bi = "bi"


def deviceSupportsBatchHint():
    """The reference's persistent-kernel batch hint: the port has none."""
    return False


def createRnn(insize, hsize, layers, mode, direction, dropout=0.0, seed=0, batchsize=None):
    """(desc, flat weight W, {pseudo-layer: {name: view of W}})."""
    from puzzlelib_tpu_torch.backend import rnn as _rnn

    desc, W, params = _rnn.createRnn(insize, hsize, layers, mode, direction, dropout, seed, batchsize)
    return desc, W, dict(enumerate(params))


def acquireRnnParams(descRnn, w):
    from puzzlelib_tpu_torch.backend import rnn as _rnn
    return w, dict(enumerate(_rnn.acquireRnnParams(descRnn, w)))


def updateRnnParams(descRnn, w, params):
    """Nothing to copy: the params are views of w."""


def forwardRnn(data, W, descRnn, test=False):
    """The output; in train mode (output, reserve)."""
    return descRnn.forward(data, W, test=test)


def backwardRnn(grad, descRnn, withData=True):
    """(input gradient, or None without ``withData``; flat weight gradient)
    of the last train forward for the output gradient ``grad``."""
    return descRnn.backward(grad, withData=withData)
