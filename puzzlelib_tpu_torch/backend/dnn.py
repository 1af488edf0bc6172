"""DNN primitive dispatch (counterpart of ``puzzlelib_tpu/backend/dnn.py``):
the conv, pool and softmax slots of the VGG slices, forward and backward, and
``convNdbenchmark``, which times a conv's three directions.

The parameter gradients are written in place into the variables' gradient
buffers (``_accumulateParamGrads``), which under an optimizer's global state
are views of its flat buffer."""

from enum import Enum

import numpy as np
import torch

from puzzlelib_tpu_torch.backend import gpuarray
from puzzlelib_tpu_torch.backend.device import getDevice, timeKernel
from puzzlelib_tpu_torch.ops import conv as _conv
from puzzlelib_tpu_torch.ops import pool as _pool
from puzzlelib_tpu_torch.ops import softmax as _softmax


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


def convNdbenchmark(datashape, Wshape, stride, pad, dilation, groups, transpose=False, dtype=np.float32):
    """Time a conv's forward, bwd-filter and bwd-data on the configured
    device, each on the route ``Config.convAlgo`` selects (K2 and K3 where
    they take the conv, the library's call elsewhere): ``(fwd, bwdFilter,
    bwdData)``, one ``ConvPerf`` list each, seconds of one call by
    ``timeKernel`` (25 calls after a warm-up), as the reference returns them.
    ``dtype`` is a numpy or torch type ("bfloat16" by name).  The
    reference's race of its kernels against XLA (``measureAlgoChoice``)
    waits for the port's per-shape race; deconvolutions are not ported."""
    from puzzlelib_tpu_torch.ops.hopper import winograd

    if transpose:
        raise NotImplementedError("convNdbenchmark of a deconvolution: the port has no deconv yet")

    stride, pad, dilation, groups = _t(stride), _t(pad), _t(dilation), int(groups)
    dtype = torch.bfloat16 if isinstance(dtype, str) and dtype == "bfloat16" else gpuarray.toTorchDtype(dtype)
    device = getDevice()

    x = torch.zeros(tuple(datashape), dtype=dtype, device=device)
    w = torch.zeros(tuple(Wshape), dtype=dtype, device=device)
    x = _conv.kernelLayout(x, tuple(w.shape), stride, pad, dilation, groups)

    def fwd():
        return _conv.convNd(x, w, None, stride, pad, dilation, groups)

    grad = fwd()

    def bwdParams():
        return _conv.convNdBackwardParams(x, grad, w, stride, pad, dilation, groups)

    def bwdData():
        return _conv.convNdBackwardData(grad, w, tuple(x.shape), stride, pad, dilation, groups)

    results = []
    for fn, counter in ((fwd, "launches"), (bwdParams, "filterGradLaunches"), (bwdData, "dataGradLaunches")):
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
