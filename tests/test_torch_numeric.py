"""``GroupLinear``, ``SpatialTf``, ``NoiseInjector`` and ``Penalty`` against
the JAX package, and the per-type twins of ``tests/test_dtypes.py``: the
``tools/layerslice.py`` cases of those modules, and the twins of
``testGroupLinear``, ``testSpatialTfIdentity``, ``testNoiseInjector`` and
``testPenalty`` (``tests/test_modules_numeric.py``).

Each twin holds the outputs, the input gradients and every parameter
gradient within 1e-5 (f32) or 5e-2 (bf16) of max(1, max |want|).  The cases
cover exact zeros under ``Penalty``'s L1 (relu outputs: the reference counts
0 as +1), a ``SpatialTf`` output side of 1 (the reference's grid puts it at
-1) and transforms that sample outside the image, ``NoiseInjector`` on the
same injected draws in both packages (``layerslice.SeededRng``), and
``GroupLinear`` in every combination of ``batchDim``, ``wmode``,
``inmode``, ``transpW``, ``useW`` and ``useBias`` that the JAX package
runs; the port runs the others too, held here to a numpy oracle.  The
card-only cases (``cuda`` marker) hold each case on CUDA tensors to its CPU
run and to a second card run."""

import itertools

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.backend import gpuarray as TGpu
from puzzlelib_tpu_torch.tools import layerslice

import layertwins as LT


SMALL = {
    "SpatialTf": [(2, 3, 6, 6), (2, 2, 3)], "SpatialTf 112": [(2, 3, 6, 6), (2, 2, 3)],
    "GroupLinear batchDim 0": [(2, layerslice.GROUPS, layerslice.GROUP_SIZE)],
    "Penalty l1": [(10, 8)], "Penalty l2": [(10, 8)],
    "NoiseInjector add uniform": [(4, 6)], "NoiseInjector add normal": [(4, 6)],
    "NoiseInjector mul uniform": [(4, 6)], "NoiseInjector mul normal": [(4, 6)],
}

CARD = dict(SMALL, **{"GroupLinear batchDim 1": [(layerslice.GROUPS, 2, layerslice.GROUP_SIZE)],
                      "GroupLinear wmode one": [(2, layerslice.GROUPS, layerslice.GROUP_SIZE)],
                      "GroupLinear wmode one batchDim 1": [(layerslice.GROUPS, 2, layerslice.GROUP_SIZE)]})


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card (the card-only
    cases set "cuda" themselves)."""
    monkeypatch.setattr(TConfig, "device", "cpu")
    monkeypatch.setattr(TConfig, "globalEvalMode", False)


@pytest.mark.parametrize("name, dtype", [(name, dtype) for name in sorted(SMALL)
                                         for dtype in layerslice.CASES[name].dtypes])
def testNumericCaseTwin(name, dtype):
    """Each case forward and backward against the JAX package, in each type
    the module takes."""
    got, _ = LT.caseTwin(name, SMALL[name], dtype, jaxTakes=True)

    if name == "Penalty l1":
        assert (layerslice.inputs(name, SMALL[name], dtype)[0] == 0).any()


# -- GroupLinear ---------------------------------------------------------------------------------

G, B, IN, OUT = 3, 4, 5, 6

# every combination: (batchDim, wmode, inmode, transpW, useW, useBias), W or b used
COMBOS = [c for c in itertools.product((0, 1), ("full", "one"), ("full", "one"), (False, True), (True, False),
                                       (True, False)) if c[4] or c[5]]


def _jaxRuns(combo):
    """Whether the JAX package runs ``combo`` (each of the others fails
    there on a shape or on its group check)."""
    batchDim, wmode, inmode, _, useW, useBias = combo
    return ((batchDim, wmode, inmode) == (0, "full", "full")
            or (batchDim, wmode, inmode, useW) in ((0, "one", "one", False), (1, "one", "full", False))
            or (batchDim, wmode, inmode, useBias) == (1, "full", "full", False))


def _groupData(batchDim, inmode, seed=0):
    rng = np.random.RandomState(seed)
    gin = G if inmode == "full" else 1
    return rng.randn(*((B, gin, IN) if batchDim == 0 else (gin, B, IN))).astype(np.float32)


def _groupLinear(M, combo):
    batchDim, wmode, inmode, transpW, useW, useBias = combo
    np.random.seed(2)
    return M.GroupLinear(G, IN, OUT, wmode=wmode, inmode=inmode, batchDim=batchDim, transpW=transpW, useW=useW,
                         useBias=useBias, initscheme="he")


def _bias(mod):
    """A bias of distinct values for ``mod``, so that its add shows."""
    shape = tuple(mod.vars["b"].data.shape)
    return np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape) / 10


@pytest.mark.parametrize("combo", [c for c in COMBOS if _jaxRuns(c)], ids=lambda c: "-".join(map(str, c)))
def testGroupLinearTwin(combo):
    """``testGroupLinear``'s layer in each combination the JAX package runs:
    the output, the input gradient, W's and b's gradients, and the shapes."""
    J, _, jgpu, _ = LT.jaxPackage()
    jmod, tmod = _groupLinear(J, combo), _groupLinear(T, combo)
    if combo[5]:
        jmod.vars["b"].data.set(_bias(jmod))
        tmod.b.copy_(torch.from_numpy(_bias(tmod)))
    x = _groupData(combo[0], combo[2])

    jout, tout = jmod(jgpu.to_gpu(x)), tmod(torch.from_numpy(x))
    LT.close(tout, jout)
    assert tuple(tmod.dataShapeFrom(x.shape)) == tuple(tout.shape)

    grad = np.random.RandomState(3).randn(*tout.shape).astype(np.float32)
    jmod.backward(jgpu.to_gpu(grad))
    tmod.backward(torch.from_numpy(grad))
    LT.close(tmod.grad, jmod.grad)
    assert tuple(tmod.gradShapeFrom(tuple(tout.shape))) == tuple(jmod.gradShapeFrom(tuple(tout.shape)))

    assert sorted(tmod.vars) == sorted(jmod.vars)
    for name in tmod.vars:
        LT.close(tmod.vars[name].grad, jmod.vars[name].grad)


def _oracle(combo, x, W, b, grad):
    """numpy's forward and gradients of the layer the module docstring
    describes: (out, dx, dW, db) in the module's layouts."""
    batchDim, wmode, inmode, transpW, useW, useBias = combo
    xg = x if batchDim == 1 else x.swapaxes(0, 1)                    # (g, batch, in)
    gg = grad if batchDim == 1 else grad.swapaxes(0, 1)
    Wm = None if W is None else (W.swapaxes(1, 2) if transpW else W)  # (g, in, out)

    out = np.matmul(xg, Wm) if useW else xg.copy()
    out = out + b[:, None, :] if useBias else out
    dx = np.matmul(gg, Wm.swapaxes(1, 2)) if useW else gg
    dx = dx.sum(axis=0, keepdims=True) if inmode == "one" else dx

    dW = db = None
    if useW:
        dW = np.matmul(np.broadcast_to(xg, gg.shape[:2] + xg.shape[2:]).swapaxes(1, 2), gg)
        dW = dW.swapaxes(1, 2) if transpW else dW
        dW = dW.sum(axis=0, keepdims=True) if wmode == "one" else dW
    if useBias:
        db = gg.sum(axis=1)
        db = db.sum(axis=0, keepdims=True) if wmode == "one" else db

    back = (lambda t: t) if batchDim == 1 else (lambda t: t.swapaxes(0, 1))
    return back(out), back(dx), dW, db


@pytest.mark.parametrize("combo", COMBOS, ids=lambda c: "-".join(map(str, c)))
def testGroupLinearEveryCombination(combo):
    """Every combination, the ones the JAX package fails on too, against
    numpy: forward, input gradient and parameter gradients, and a second
    backward with scale 0.5 and momentum 0.25 folding into the gradients."""
    tmod = _groupLinear(T, combo)
    if combo[5]:
        tmod.b.copy_(torch.from_numpy(_bias(tmod)))
    x = _groupData(combo[0], combo[2])

    out = tmod(torch.from_numpy(x))
    grad = np.random.RandomState(3).randn(*out.shape).astype(np.float32)
    tmod.backward(torch.from_numpy(grad))

    W = tmod.W.numpy() if tmod.W is not None else None
    b = tmod.b.numpy() if tmod.b is not None else None
    want = _oracle(combo, x, W, b, grad)
    params = [tmod.vars[name].grad if name in tmod.vars else None for name in ("W", "b")]
    for got, ref in zip([out, tmod.grad] + params, want):
        if ref is not None:
            LT.close(got, ref)

    before = {name: var.grad.clone() for name, var in tmod.vars.items()}
    tmod.backward(torch.from_numpy(grad), scale=0.5, momentum=0.25)
    for name, var in tmod.vars.items():
        LT.close(var.grad, 0.5 * before[name] + 0.25 * before[name])


# -- SpatialTf ----------------------------------------------------------------------------------

def testSpatialTfIdentityTwin():
    """``testSpatialTfIdentity``: the identity transform gives the data back
    in both packages, and the gradients of both inputs agree."""
    J, _, jgpu, _ = LT.jaxPackage()
    np.random.seed(9)
    data = np.random.randn(2, 3, 6, 6).astype(np.float32)
    theta = np.tile(np.array([[1, 0, 0], [0, 1, 0]], np.float32), (2, 1, 1))

    jmod, tmod = J.SpatialTf(), T.SpatialTf()
    jout = jmod([jgpu.to_gpu(data), jgpu.to_gpu(theta)])
    tout = tmod([torch.from_numpy(data), torch.from_numpy(theta)])
    LT.close(tout, jout)
    assert np.allclose(tout.numpy(), data, atol=1e-4)

    grad = np.random.randn(*data.shape).astype(np.float32)
    jmod.backward(jgpu.to_gpu(grad))
    tmod.backward(torch.from_numpy(grad))
    (jdx, jdtheta), (tdx, tdtheta) = jmod.grad, tmod.grad
    LT.close(tdx, jdx)
    LT.close(tdtheta, jdtheta)
    assert tuple(tdtheta.shape) == (2, 2, 3)


@pytest.mark.parametrize("outshape", [(3, 1, 4), (3, 5, 1), (3, 1, 1), (3, 9, 7)])
def testSpatialTfOutputSidesTwin(outshape):
    """Outputs with a side of 1 (where the reference's grid sits at -1, not
    at ``affine_grid``'s 0) and transforms that sample outside the image."""
    J, _, jgpu, _ = LT.jaxPackage()
    rng = np.random.RandomState(4)
    data = rng.randn(3, 3, 6, 5).astype(np.float32)
    theta = (np.array([[1, 0, 0], [0, 1, 0]], np.float32) + 0.8 * rng.randn(3, 2, 3)).astype(np.float32)

    jmod, tmod = J.SpatialTf(shape=outshape), T.SpatialTf(shape=outshape)
    jout = jmod([jgpu.to_gpu(data), jgpu.to_gpu(theta)])
    tout = tmod([torch.from_numpy(data), torch.from_numpy(theta)])
    LT.close(tout, jout)
    assert tuple(tout.shape) == (3, ) + outshape == tuple(tmod.dataShapeFrom([data.shape, theta.shape]))

    grad = rng.randn(*tout.shape).astype(np.float32)
    jmod.backward(jgpu.to_gpu(grad))
    tmod.backward(torch.from_numpy(grad))
    for tg, jg in zip(tmod.grad, jmod.grad):
        LT.close(tg, jg)


def testSpatialTfEvalModeKeepsNoGrid():
    mod = T.SpatialTf()
    mod.evalMode()
    mod([torch.randn(1, 2, 4, 4), torch.eye(2, 3)[None]])
    assert mod.grid is None


# -- NoiseInjector and Penalty -------------------------------------------------------------------

def testNoiseInjectorTwin():
    """``testNoiseInjector``'s checks on the port, on the same injected
    draws as the JAX module: the additive noise is ``rands`` and within its
    range, the additive backward passes the gradient on, the multiplicative
    one scales it by the same draws, and eval mode draws nothing."""
    J, _, jgpu, _ = LT.jaxPackage()
    np.random.seed(14)
    data = np.random.randn(4, 6).astype(np.float32)
    grad = np.random.randn(4, 6).astype(np.float32)

    for mode, kind, params in (("add", "uniform", (-0.5, 0.5)), ("mul", "gaussian", (1.0, 0.1))):
        jmod = J.NoiseInjector(mode=mode, noisetype=kind, params=params, rng=layerslice.SeededRng())
        tmod = T.NoiseInjector(mode=mode, noisetype=kind, params=params, rng=layerslice.SeededRng())
        jout, tout = jmod(jgpu.to_gpu(data)), tmod(torch.from_numpy(data))
        LT.close(tout, jout)
        LT.close(tmod.rands, jmod.rands)

        rands = tmod.rands.numpy()
        if mode == "add":
            assert np.allclose(tout.numpy() - data, rands, atol=1e-6) and -0.5 <= rands.min() <= rands.max() <= 0.5
        else:
            assert np.allclose(tout.numpy(), data * rands, atol=1e-6)

        jmod.backward(jgpu.to_gpu(grad))
        tmod.backward(torch.from_numpy(grad))
        LT.close(tmod.grad, jmod.grad)
        assert np.allclose(tmod.grad.numpy(), grad if mode == "add" else grad * rands, atol=1e-6)

    mod = T.NoiseInjector(mode="add")
    mod.evalMode()
    x = torch.from_numpy(data)
    assert mod(x) is x and mod.rands is None


def testNoiseInjectorSlicingAndInplace():
    """``slicing`` injects into the selected cells of the flat view only;
    ``inplace`` writes over the input, as the JAX module does."""
    J, _, jgpu, _ = LT.jaxPackage()
    data = np.random.RandomState(5).randn(3, 8).astype(np.float32)

    jmod = J.NoiseInjector(mode="add", rng=layerslice.SeededRng(), slicing=slice(4, 17))
    tmod = T.NoiseInjector(mode="add", rng=layerslice.SeededRng(), slicing=slice(4, 17))
    jout, tout = jmod(jgpu.to_gpu(data)), tmod(torch.from_numpy(data))
    LT.close(tout, jout)
    assert np.array_equal(tout.numpy().reshape(-1)[:4], data.reshape(-1)[:4])

    x = torch.from_numpy(data.copy())
    out = T.NoiseInjector(mode="mul", rng=layerslice.SeededRng(), inplace=True)(x)
    assert out.data_ptr() == x.data_ptr()


def testPenaltyTwin():
    """``testPenalty``: the forward is the identity, the L1 backward takes
    weight / batch * sign(data) with sign(0) = +1, the L2 one weight /
    batch * data; exact zeros in the data."""
    J, _, jgpu, _ = LT.jaxPackage()
    np.random.seed(15)
    data = np.maximum(np.random.randn(10, 8), 0).astype(np.float32)
    grad = np.random.randn(10, 8).astype(np.float32)
    assert (data == 0).any()

    for mode in ("l1", "l2"):
        jmod, tmod = J.Penalty(mode=mode, weight=1e-2), T.Penalty(mode=mode, weight=1e-2)
        jout, tout = jmod(jgpu.to_gpu(data)), tmod(torch.from_numpy(data))
        assert np.array_equal(tout.numpy(), data) and np.array_equal(LT.host(jout), data)

        jmod.backward(jgpu.to_gpu(grad))
        tmod.backward(torch.from_numpy(grad))
        assert np.array_equal(tmod.grad.numpy(), LT.host(jmod.grad))

        sign = np.where(data >= 0, 1.0, -1.0) if mode == "l1" else data
        assert np.allclose(tmod.grad.numpy(), grad - 1e-2 / 10 * sign, atol=1e-6)


@pytest.mark.parametrize("build", [lambda M: M.SpatialTf(), lambda M: M.Penalty(),
                                   lambda M: M.GroupLinear(2, 3, 4)])
def testModulesTakeF32Only(build):
    """As in the JAX package, SpatialTf, Penalty and GroupLinear refuse any
    type but f32."""
    J = LT.jaxPackage()[0]
    import ml_dtypes

    with pytest.raises(J.ModuleError):
        build(J).calcMode(ml_dtypes.bfloat16)
    with pytest.raises(T.ModuleError):
        build(T).calcMode(torch.bfloat16)


# -- tests/test_dtypes.py ----------------------------------------------------------------------------

def _dtypes():
    """(port type, JAX type, tolerance) of each type both packages take, in
    the same order in both."""
    jgpu = LT.jaxPackage()[2]
    return [(t, j, atol) for (t, atol), (j, _) in zip(TGpu.dtypesSupported(), jgpu.dtypesSupported())]


def _perDtype(build, shape, seed, dtype):
    """The module of each package in ``dtype``, forward and backward on the
    same seeded values: the outputs, the input gradients and the W
    gradients held at the type's tolerance, the types kept."""
    J, _, jgpu, _ = LT.jaxPackage()
    (ttype, jtype, atol), = [d for d in _dtypes() if d[0] == dtype]

    np.random.seed(seed)
    jmod = build(J)
    np.random.seed(seed)
    tmod = build(T)
    jmod.calcMode(jtype)
    tmod.calcMode(ttype)

    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(ttype)
    jout, tout = jmod(jgpu.to_gpu(x.float().numpy().astype(jtype))), tmod(x)
    assert tout.dtype == ttype
    assert np.allclose(LT.host(tout), LT.host(jout), atol=atol)

    g = torch.from_numpy(rng.randn(*tout.shape).astype(np.float32)).to(ttype)
    jmod.backward(jgpu.to_gpu(g.float().numpy().astype(jtype)))
    tmod.backward(g)
    assert tmod.grad.dtype == ttype and np.allclose(LT.host(tmod.grad), LT.host(jmod.grad), atol=atol)
    for name in tmod.vars:
        assert np.allclose(LT.host(tmod.vars[name].grad), LT.host(jmod.vars[name].grad), atol=atol * 4)


def _portTypes():
    return [t for t, _ in TGpu.dtypesSupported()]


@pytest.mark.parametrize("dtype", _portTypes(), ids=str)
def testLinearPerDtypeTwin(dtype):
    _perDtype(lambda M: M.Linear(8, 6, initscheme=("xavier", "avg")), (4, 8), 0, dtype)


@pytest.mark.parametrize("dtype", _portTypes(), ids=str)
def testConvPerDtypeTwin(dtype):
    _perDtype(lambda M: M.Conv2D(2, 3, 3, pad=1), (2, 2, 6, 6), 1, dtype)


@pytest.mark.parametrize("dtype", _portTypes(), ids=str)
def testActivationPerDtypeTwin(dtype):
    _perDtype(lambda M: M.Activation(M.tanh), (5, 7), 2, dtype)


@pytest.mark.parametrize("dtype", _portTypes(), ids=str)
@pytest.mark.parametrize("pool", ["MaxPool2D", "AvgPool2D"])
def testPoolPerDtypeTwin(pool, dtype):
    _perDtype(lambda M: getattr(M, pool)(), (2, 3, 8, 8), 3, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD))
def testNumericCaseOnCard(name):
    """Each case on CUDA tensors against its CPU run and a second card run."""
    LT.cardAgainstCpu(name, CARD[name])
