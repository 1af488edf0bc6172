"""The deconvolution against the JAX package: ``Deconv2D`` / ``DeconvND``
forward, input gradient and parameter gradients (``ops.conv.deconvNd`` and
its two backward ops), and ``convNdbenchmark`` of a deconvolution.

Each twin builds the JAX module and the port's from one numpy seed (the
weights drawn with ``factorTranspose``, the same in both); f32 is held
within 1e-5 of max(1, max |want|), bf16 within 5e-2 of it.  The card-only
cases (``cuda`` marker) hold the ops on CUDA tensors to their CPU results
and send a stride-1 3x3 deconv with 128 maps through K2 and K3."""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.backend import dnn
from puzzlelib_tpu_torch.ops import conv as convOps


BOUNDS = {"f32": 1e-5, "bf16": 5e-2}

# (inmaps, outmaps, size, stride, pad, postpad, groups, useBias, input map)
CASES = {
    "unet-2x2-s2": (8, 4, 2, 2, 0, 0, 1, False, (5, 6)),
    "3x3-s1-p1-bias": (6, 5, 3, 1, 1, 0, 1, True, (7, 5)),
    "3x3-s2-postpad1": (4, 6, 3, 2, 1, 1, 1, True, (5, 4)),
    "groups2": (6, 4, 3, 2, 0, 0, 2, False, (4, 5)),
}


def _jax():
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    import ml_dtypes
    from puzzlelib_tpu import modules
    from puzzlelib_tpu.backend import gpuarray

    return modules, gpuarray, {"f32": (np.float32, torch.float32), "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    monkeypatch.setattr(TConfig, "device", "cpu")


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()

    return np.asarray(value.get(), dtype=np.float32)


def _close(got, want, bound):
    got, want = _host(got), _host(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def _pair(case, initscheme="he"):
    J = _jax()[0]
    inmaps, outmaps, size, stride, pad, postpad, groups, useBias, _ = CASES[case]
    kwargs = dict(stride=stride, pad=pad, postpad=postpad, groups=groups, useBias=useBias, initscheme=initscheme)

    np.random.seed(5)
    jmod = J.Deconv2D(inmaps, outmaps, size, **kwargs)
    np.random.seed(5)
    tmod = T.Deconv2D(inmaps, outmaps, size, **kwargs)
    return jmod, tmod


def _bias(jmod, tmod):
    """A nonzero bias, the same in both (it starts at zero)."""
    if tmod.b is not None:
        b = np.random.RandomState(6).randn(*tmod.b.shape).astype(np.float32)
        jmod.b.set(b)
        tmod.b.copy_(torch.from_numpy(b))


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
@pytest.mark.parametrize("case", sorted(CASES))
def testDeconv2DTwin(case, dtype):
    """The forward, the input gradient and the weight and bias gradients of
    one backward, against the JAX package's; the shapes the modules predict
    too."""
    _, jgpu, types = _jax()
    jtype, ttype = types[dtype]
    jmod, tmod = _pair(case)
    assert np.array_equal(_host(tmod.W), _host(jmod.W))
    _bias(jmod, tmod)

    inmaps, _, _, _, _, _, _, useBias, hw = CASES[case]
    x = np.random.RandomState(7).randn(3, inmaps, *hw).astype(np.float32)
    if dtype != "f32":
        jmod.calcMode(jtype)
        tmod.calcMode(ttype)

    jout = jmod(jgpu.to_gpu(x.astype(jtype)))
    tout = tmod(torch.from_numpy(x).to(ttype))
    assert tuple(tout.shape) == tmod.dataShapeFrom(x.shape) == jmod.dataShapeFrom(x.shape)
    _close(tout, jout, BOUNDS[dtype])

    grad = np.random.RandomState(8).randn(*tout.shape).astype(np.float32)
    jmod.backward(jgpu.to_gpu(grad.astype(jtype)))
    tmod.backward(torch.from_numpy(grad).to(ttype))
    assert tmod.gradShapeFrom(tuple(tout.shape)) == x.shape
    _close(tmod.grad, jmod.grad, BOUNDS[dtype])
    _close(tmod.vars["W"].grad, jmod.vars["W"].grad, BOUNDS[dtype])
    if useBias:
        _close(tmod.vars["b"].grad, jmod.vars["b"].grad, BOUNDS[dtype])


def testDeconvAccGradParamsScaleMomentumTwin():
    """``accGradParams`` folds the new gradients into the buffers as grad *
    scale + buffer * momentum, as the JAX package's does."""
    _, jgpu, _ = _jax()
    jmod, tmod = _pair("3x3-s1-p1-bias")
    x = np.random.RandomState(9).randn(2, 6, 7, 5).astype(np.float32)
    grad = np.random.RandomState(10).randn(2, 5, 7, 5).astype(np.float32)

    jmod(jgpu.to_gpu(x))
    tmod(torch.from_numpy(x))
    for scale, momentum in ((1.0, 0.0), (0.5, 0.9), (2.0, 1.0)):
        jmod.accGradParams(jgpu.to_gpu(grad), scale=scale, momentum=momentum)
        tmod.accGradParams(torch.from_numpy(grad), scale=scale, momentum=momentum)

    _close(tmod.vars["W"].grad, jmod.vars["W"].grad, BOUNDS["f32"])
    _close(tmod.vars["b"].grad, jmod.vars["b"].grad, BOUNDS["f32"])


def testGroupedDeconvWithABiasFailsAsInTheReference():
    """With groups > 1 the bias has outmaps // groups maps in both packages,
    so the forward cannot add it: both refuse it; without a bias the grouped
    deconv runs (``testDeconv2DTwin`` "groups2")."""
    J, jgpu, _ = _jax()
    np.random.seed(5)
    jmod = J.Deconv2D(6, 4, 3, stride=2, groups=2, useBias=True)
    tmod = T.Deconv2D(6, 4, 3, stride=2, groups=2, useBias=True)
    assert tuple(tmod.b.shape) == tuple(jmod.b.shape) == (1, 2, 1, 1)

    x = np.zeros((1, 6, 4, 4), np.float32)
    with pytest.raises(TypeError, match="broadcasting"):
        jmod(jgpu.to_gpu(x))
    with pytest.raises(RuntimeError):
        tmod(torch.from_numpy(x))


def testDeconvRefusals():
    with pytest.raises(T.ModuleError, match="Postpad"):
        T.Deconv2D(4, 4, 3, stride=2, postpad=2)
    with pytest.raises(T.ModuleError, match="divisible"):
        T.Deconv2D(5, 4, 3, groups=2)

    mod = T.Deconv2D(4, 6, 3)
    assert (mod.fwdAlgo, mod.bwdDataAlgo, mod.bwdFilterAlgo) == (dnn.ConvFwdAlgo.auto, dnn.ConvBwdDataAlgo.auto,
                                                                 dnn.ConvBwdFilterAlgo.auto)
    with pytest.raises(T.ModuleError, match="maps"):
        mod(torch.zeros(1, 5, 4, 4))


def testDeconvOptimizeForShapeTimesTheThreeDirections():
    """``optimizeForShape`` times the deconvolution's three directions on
    its output's shape, on the library route here."""
    mod = T.Deconv2D(8, 4, 2, stride=2, useBias=False)
    mod.optimizeForShape((2, 8, 6, 6))

    fwd, bwdFilter, bwdData = dnn.convNdbenchmark((2, 4, 12, 12), (8, 4, 2, 2), (2, 2), (0, 0), (1, 1), 1,
                                                  transpose=True)
    assert all(perfs[0].time > 0 for perfs in (fwd, bwdFilter, bwdData))


# -- on the card ---------------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    from puzzlelib_tpu_torch.backend.device import ensureInit
    ensureInit()   # TF32 off


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def testDeconvOpsOnCard(monkeypatch, case):
    """deconvNd and its two backward ops on CUDA tensors against their CPU
    results, f32 (TF32 off) and bf16."""
    _card()
    inmaps, outmaps, size, stride, pad, postpad, groups, _, hw = CASES[case]
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, inmaps, *hw, generator=gen)
    w = torch.randn(inmaps, outmaps // groups, size, size, generator=gen)
    s, p, d, pp = (stride, stride), (pad, pad), (1, 1), (postpad, postpad)
    out = convOps.deconvNd(x, w, None, s, p, d, pp, groups)
    grad = torch.randn(out.shape, generator=gen)

    def ops(device, dtype):
        xs, ws, gs = (t.to(device, dtype) for t in (x, w, grad))
        return (convOps.deconvNd(xs, ws, None, s, p, d, pp, groups),
                convOps.deconvNdBackwardData(gs, ws, s, p, d, groups),
                convOps.deconvNdBackwardParams(xs, gs, ws, s, p, d, groups)[0])

    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
        for got, want in zip(ops("cuda", dtype), ops("cpu", dtype)):
            got, want = got.float().cpu(), want.float()
            assert ((got - want).norm() / want.norm()).item() <= tol


@pytest.mark.cuda
def testStrideOneDeconvRunsOnTheWinogradKernels(monkeypatch):
    """A bf16 stride-1 3x3 deconv with 128 maps in and out goes to K2 (its
    forward, through ``winograd.dataGrad``, and its bwd-data) and K3 (its
    bwd-filter), within 5e-2 of the library route."""
    _card()
    from puzzlelib_tpu_torch.ops.hopper import winograd

    monkeypatch.setattr(TConfig, "device", "cuda")
    np.random.seed(5)
    mod = T.Deconv2D(128, 128, 3, pad=1, initscheme="he")
    mod.calcMode(torch.bfloat16)
    x = torch.randn(2, 128, 12, 12, device="cuda").to(torch.bfloat16)
    grad = torch.randn(2, 128, 12, 12, device="cuda").to(torch.bfloat16)

    results = {}
    for algo in ("torch", "hopper"):
        monkeypatch.setattr(TConfig, "convAlgo", algo)
        before = (winograd.launches, winograd.dataGradLaunches, winograd.filterGradLaunches)
        mod.zeroGradParams()
        out = mod(x)
        mod.backward(grad)
        after = (winograd.launches, winograd.dataGradLaunches, winograd.filterGradLaunches)
        results[algo] = (out.float(), mod.grad.float(), mod.vars["W"].grad.float(),
                         tuple(a - b for a, b in zip(after, before)))

    assert results["torch"][3] == (0, 0, 0) and results["hopper"][3] == (2, 1, 1)
    for got, want in zip(results["hopper"][:3], results["torch"][:3]):
        assert ((got - want).norm() / want.norm()).item() <= 5e-2
