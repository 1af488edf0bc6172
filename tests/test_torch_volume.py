"""The 3-d modules, ``Deconv1D`` and the 1-d pools' backward against the JAX
package: the ``tools/layerslice.py`` cases of ``Deconv1D``, ``Deconv3D``,
``MaxPool3D`` (non-overlapping, overlapping and C3D's padded pool5),
``AvgPool3D`` (non-overlapping and overlapping) and the 1-d pools, and the
twins of ``testConv3D``, ``testDeconv1D``, ``testDeconv3D``,
``testMaxPool3D``, ``testAvgPool3D`` and ``testAvgPool1D``
(``tests/test_modules_nd.py``), in f32 and bf16 (the JAX package's conv,
deconv and pool modules take bf16).

Each twin holds the output, the input gradient and every parameter gradient
within 1e-5 (f32) or 5e-2 (bf16) of max(1, max |want|).  The cases read
relu outputs where they pool by the maximum, so whole windows tie at 0 and
the gradient goes to each window's first cell in both packages.  Where 3-d
windows overlap the port adds the gradient window cell by window cell
(``ops.pool._scatterWindows``), which is held here to the library's backward
too.  The card-only cases (``cuda`` marker) hold each case on CUDA tensors
to its CPU run and to a second card run, bit for bit."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.ops import pool as TPool

import layertwins as LT


SMALL = {
    "Deconv1D": [(2, 256, 9)], "Deconv3D": [(1, 256, 2, 3, 3)],
    "MaxPool3D 2x2x2/2": [(2, 3, 4, 6, 8)], "MaxPool3D 3x3x3/2": [(2, 2, 5, 7, 7)],
    "MaxPool3D C3D pool5": [(2, 4, 2, 7, 7)],
    "AvgPool3D 2x2x2/2": [(2, 2, 4, 4, 6)], "AvgPool3D 3x3x3/2": [(2, 2, 5, 7, 7)],
    "MaxPool1D 5/2": [(3, 4, 10)], "AvgPool1D 5/2": [(3, 4, 10)],
}


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card (the card-only
    cases set "cuda" themselves)."""
    monkeypatch.setattr(TConfig, "device", "cpu")
    monkeypatch.setattr(TConfig, "globalEvalMode", False)


@pytest.mark.parametrize("dtype", sorted(LT.BOUNDS))
@pytest.mark.parametrize("name", sorted(SMALL))
def testVolumeCaseTwin(name, dtype):
    """Each case forward and backward against the JAX package."""
    LT.caseTwin(name, SMALL[name], dtype, jaxTakes=True)


def _twin(build, shape, seed, dtype):
    """The module of each package from ``build`` and one numpy seed,
    forward and backward on the same seeded data and gradient in
    ``dtype``: the output, the input gradient and every parameter
    gradient."""
    J, _, jgpu, types = LT.jaxPackage()
    ttype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]

    np.random.seed(seed)
    jmod = build(J)
    np.random.seed(seed)
    tmod = build(T)
    if dtype != "f32":
        jmod.calcMode(types[dtype])
        tmod.calcMode(ttype)

    rng = np.random.RandomState(seed)
    x = LT.layerslice._typed([rng.randn(*shape).astype(np.float32)], dtype)[0]
    jout, tout = jmod(jgpu.to_gpu(x.astype(types[dtype]))), tmod(torch.from_numpy(x).to(ttype))
    LT.close(tout, jout, LT.BOUNDS[dtype])

    grad = LT.layerslice._typed([rng.randn(*tout.shape).astype(np.float32)], dtype)[0]
    jmod.backward(jgpu.to_gpu(grad.astype(types[dtype])))
    tmod.backward(torch.from_numpy(grad).to(ttype))
    LT.close(tmod.grad, jmod.grad, LT.BOUNDS[dtype])

    assert sorted(tmod.vars) == sorted(jmod.vars)
    for name in tmod.vars:
        LT.close(tmod.vars[name].grad, jmod.vars[name].grad, LT.BOUNDS[dtype])

    assert tuple(tmod.dataShapeFrom(shape)) == tuple(jmod.dataShapeFrom(shape)) == tuple(tout.shape)
    return tmod


# the cases of tests/test_modules_nd.py: (builder, data shape, numpy seed)
ND_CASES = {
    "Conv3D": (lambda M: M.Conv3D(2, 3, size=3, stride=2, pad=1), (2, 2, 6, 7, 8), 20),
    "Deconv1D": (lambda M: M.Deconv1D(3, 2, size=4, stride=2, pad=1), (2, 3, 9), 21),
    "Deconv3D": (lambda M: M.Deconv3D(2, 3, size=3, stride=2), (2, 2, 4, 5, 4), 22),
    "MaxPool3D": (lambda M: M.MaxPool3D(size=2, stride=2), (2, 3, 4, 6, 8), 23),
    "AvgPool3D": (lambda M: M.AvgPool3D(size=2, stride=2, pad=1, includePad=True), (2, 2, 4, 4, 6), 24),
    "AvgPool1D": (lambda M: M.AvgPool1D(size=3, stride=2, pad=1, includePad=False), (3, 4, 10), 25),
}


@pytest.mark.parametrize("dtype", sorted(LT.BOUNDS))
@pytest.mark.parametrize("name", sorted(ND_CASES))
def testModulesNdTwin(name, dtype):
    """The cases of ``tests/test_modules_nd.py`` in both packages, and the
    shapes both answer."""
    build, shape, seed = ND_CASES[name]
    _twin(build, shape, seed, dtype)


def testConv3DGradShape():
    """``gradShapeFrom`` inverts ``dataShapeFrom`` where the stride divides
    evenly, in both packages."""
    J = LT.jaxPackage()[0]
    np.random.seed(0)
    jmod, tmod = J.Conv3D(4, 6, 3, stride=2, pad=1), T.Conv3D(4, 6, 3, stride=2, pad=1)
    assert tuple(tmod.gradShapeFrom((2, 6, 3, 4, 5))) == tuple(jmod.gradShapeFrom((2, 6, 3, 4, 5))) == (2, 4, 5, 7, 9)


def testTiedWindowGoesToTheFirstCell():
    """A 3-d window of equal maxima sends its gradient to its first cell in
    window order, overlapping or not, as the reference's VJP does."""
    for size, stride in ((2, 2), (3, 2)):
        x = torch.zeros(1, 1, 3, 3, 3)
        mod = T.MaxPool3D(size, stride)
        out = mod(x)
        mod.backward(torch.ones_like(out))

        want = torch.zeros_like(x)
        want[0, 0, 0, 0, 0] = float(out.numel())
        assert torch.equal(mod.grad, want)


@pytest.mark.parametrize("mode", ["max", "avgWithPad", "avgNoPad"])
def testOverlappingScatterIsTheLibrarysBackward(mode):
    """The window-by-window form of an overlapping 3-d pool's backward gives
    the library's backward (f64 on the CPU)."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 3, 7, 6, 9, dtype=torch.float64, generator=gen)
    size, stride, pad = (3, 3, 2), (2, 1, 2), (1, 1, 0)

    leaf = x.clone().requires_grad_()
    out = F.max_pool3d(leaf, size, stride, pad) if mode == "max" else \
        F.avg_pool3d(leaf, size, stride, pad, count_include_pad=mode == "avgWithPad")
    grad = torch.randn(out.shape, dtype=torch.float64, generator=gen)
    out.backward(grad)

    got = TPool.poolNdBackward(grad, x, size, stride, pad, mode)
    assert torch.allclose(got, leaf.grad, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("nd", [1, 2, 3])
@pytest.mark.parametrize("mode", ["max", "avgWithPad", "avgNoPad"])
def testPoolBackwardTakesEveryNd(nd, mode):
    """The pool backward takes 1-, 2- and 3-d pools in every mode, with
    overlapping windows: the library's gradient of the forward."""
    gen = torch.Generator().manual_seed(nd)
    x = torch.randn((2, 3) + (7, ) * nd, generator=gen)
    size, stride, pad = (3, ) * nd, (2, ) * nd, (1, ) * nd

    leaf = x.clone().requires_grad_()
    out = TPool.poolNd(leaf, size, stride, pad, mode)
    grad = torch.randn(out.shape, generator=gen)
    out.backward(grad)

    assert torch.allclose(TPool.poolNdBackward(grad, x, size, stride, pad, mode), leaf.grad, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def testVolumeCaseOnCard(name):
    """Each case on CUDA tensors against its CPU run and a second card run."""
    LT.cardAgainstCpu(name, SMALL[name])
