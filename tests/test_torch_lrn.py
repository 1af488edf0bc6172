"""The LRN family, ``SubtractMean`` and ``LCN`` against the JAX package: the
``tools/layerslice.py`` cases of ``CrossMapLRN`` (an odd and an even
window), ``MapLRN``, ``SubtractMean`` and ``LCN`` (both ``includePad``
modes), and the twins of ``testCrossMapLRN`` (``tests/test_backend_ops.py``)
and of ``testMapLRN`` and ``testLCNAndSubtractMean``
(``tests/test_modules_numeric.py``).

Each twin runs the JAX module and the port's forward and backward on the same
seeded inputs and output gradient and holds the output and the input
gradient within 1e-5 of max(1, max |want|).  The port's LRN backward is
written in closed form, where the JAX package takes the VJP, so the even
window (whose backward sums over the mirrored window) and alpha = 1 (where
the window's term weighs) are among the cases.  These modules take f32 only
in both packages.  The card-only cases (``cuda`` marker) hold each case on
CUDA tensors to its CPU run and to a second card run, bit for bit."""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.ops import norm as TNorm

import layertwins as LT


SMALL = {
    "CrossMapLRN N=5": [(2, 7, 5, 6)], "CrossMapLRN N=4": [(2, 7, 5, 6)], "MapLRN": [(2, 2, 7, 7)],
    "SubtractMean": [(2, 3, 9, 9)], "SubtractMean no pad": [(2, 3, 9, 9)],
    "LCN": [(2, 3, 9, 9)], "LCN no pad": [(2, 3, 9, 9)],
}


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card (the card-only
    cases set "cuda" themselves)."""
    monkeypatch.setattr(TConfig, "device", "cpu")
    monkeypatch.setattr(TConfig, "globalEvalMode", False)


@pytest.mark.parametrize("name", sorted(SMALL))
def testNormCaseTwin(name):
    """Each case forward and backward against the JAX package."""
    LT.caseTwin(name, SMALL[name], "f32", jaxTakes=True)


def _moduleTwin(jmod, tmod, x, grad):
    _, _, jgpu, _ = LT.jaxPackage()
    jout, tout = jmod(jgpu.to_gpu(x)), tmod(torch.from_numpy(x))
    LT.close(tout, jout)

    jmod.backward(jgpu.to_gpu(grad))
    tmod.backward(torch.from_numpy(grad))
    LT.close(tmod.grad, jmod.grad)
    return tout, tmod.grad


@pytest.mark.parametrize("N, K", [(5, 2.0), (4, 1.0), (1, 2.0)])
def testCrossMapLRNTwin(N, K):
    """``testCrossMapLRN``'s case: the forward against the formula the
    reference test writes out (a window of N // 2 maps back, N - 1 - N // 2
    forward), and against the JAX module, with the backward."""
    J = LT.jaxPackage()[0]
    rng = np.random.RandomState(8)
    x, grad = rng.randn(2, 8, 4, 4).astype(np.float32), rng.randn(2, 8, 4, 4).astype(np.float32)
    alpha, beta = 0.5, 0.75

    out, _ = TNorm.crossMapLRN(torch.from_numpy(x), N, alpha, beta, K)
    want = np.zeros_like(x)
    for c in range(8):
        lo, hi = max(0, c - N // 2), min(8, c + N - N // 2)
        want[:, c] = x[:, c] / (K + alpha / N * (x[:, lo:hi] ** 2).sum(axis=1)) ** beta
    LT.close(out, want)

    _moduleTwin(J.CrossMapLRN(N=N, alpha=alpha, beta=beta, K=K), T.CrossMapLRN(N=N, alpha=alpha, beta=beta, K=K),
                x, grad)


def testMapLRNTwin():
    """``testMapLRN``'s case (N = 3 and the defaults) in both packages."""
    J = LT.jaxPackage()[0]
    np.random.seed(13)
    x = np.random.randn(2, 2, 7, 7).astype(np.float32)
    grad = np.random.randn(*x.shape).astype(np.float32)

    out, ingrad = _moduleTwin(J.MapLRN(N=3), T.MapLRN(N=3), x, grad)
    assert tuple(out.shape) == tuple(ingrad.shape) == x.shape


@pytest.mark.parametrize("includePad", [True, False])
def testLCNAndSubtractMeanTwin(includePad):
    """``testLCNAndSubtractMean``'s case in both pad modes: the JAX modules'
    outputs and input gradients, and the reference test's check that
    ``SubtractMean``'s backward is its forward's adjoint."""
    J = LT.jaxPackage()[0]
    np.random.seed(11)
    x = np.random.randn(2, 3, 9, 9).astype(np.float32)
    grad = np.random.randn(*x.shape).astype(np.float32)

    out, ingrad = _moduleTwin(J.SubtractMean(size=5, includePad=includePad),
                              T.SubtractMean(size=5, includePad=includePad), x, grad)
    assert np.isclose((out.numpy() * grad).sum(), (x * ingrad.numpy()).sum(), rtol=1e-3)

    _moduleTwin(J.LCN(N=5, includePad=includePad), T.LCN(N=5, includePad=includePad), x, grad)


def testLCNGradientIsTheCompositesVjp():
    """The hand-written LCN backward (du - the pool's backward of du) against
    autograd through the composite x -> divNorm(x, avgpool(x)) in f64."""
    x = torch.randn(2, 3, 8, 7, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    grad = torch.randn(2, 3, 8, 7, dtype=torch.float64, generator=torch.Generator().manual_seed(4))

    for includePad in (True, False):
        mod = T.LCN(N=5, alpha=1.0, includePad=includePad)
        mod.calctype = torch.float64
        mod(x)
        mod.backward(grad)

        leaf = x.clone().requires_grad_()
        means = torch.nn.functional.avg_pool2d(leaf, 5, 1, 2, count_include_pad=includePad)
        u = leaf - means
        s = torch.nn.functional.avg_pool2d(u * u, 5, 1, 2, divisor_override=1)
        (u / (2.0 + 1.0 / 25 * s) ** 0.75).backward(grad)
        assert torch.allclose(mod.grad.double(), leaf.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("build", [lambda M: M.CrossMapLRN(), lambda M: M.MapLRN(), lambda M: M.LCN(),
                                   lambda M: M.SubtractMean()])
def testNormModulesTakeF32Only(build):
    """As in the JAX package, the LRN family, LCN and SubtractMean refuse any
    type but f32."""
    J = LT.jaxPackage()[0]
    import ml_dtypes

    with pytest.raises(J.ModuleError):
        build(J).calcMode(ml_dtypes.bfloat16)

    with pytest.raises(T.ModuleError):
        build(T).calcMode(torch.bfloat16)


def testEvalModeKeepsNoWorkspace():
    """In eval mode the forward keeps no denominator, as the reference's
    ``test`` forward keeps none."""
    mod = T.CrossMapLRN()
    mod.evalMode()
    mod(torch.randn(2, 6, 3, 3))
    assert mod.workspace is None


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def testNormCaseOnCard(name):
    """Each case on CUDA tensors against its CPU run and a second card run."""
    LT.cardAgainstCpu(name, SMALL[name])
