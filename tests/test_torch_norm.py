"""The batch-norm family (``BatchNorm``, ``BatchNorm1D`` / ``2D`` / ``3D``,
``InstanceNorm2D``), ``Identity``, ``Replicate`` and ``Parallel`` against the
JAX package's, and what they stand on: ``ops/norm.py``, the module
attributes (``setAttr``, ``getAttrTable``), their tables in ``convert``,
the fused step's buffer collectors and the factor inside a fused step.

Each twin builds the JAX module and the port's from the same numpy seed (the
port keeps the reference's numpy sampler, so the scales are the same draws),
gives both the same numpy input, made from a seed, and compares the outputs,
the input gradient, the scale and bias gradients and the running stats: f32
within 1e-5 of max(1, max |want|), bf16 within 5e-2 relative L2."""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import containers as TC
from puzzlelib_tpu_torch import fused, fusedctx
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.convert import attrsFromNumpy, attrsToNumpy, paramsFromNumpy
from puzzlelib_tpu_torch.modules import ModuleError
from puzzlelib_tpu_torch.ops import norm
from puzzlelib_tpu_torch.optimizers import MomentumSGD


F32_BOUND = 1e-5
BF16_BOUND = 5e-2


class _PerActivationTwin:
    """The JAX package's per-activation ``BatchNorm`` fails in train mode (its
    ``batchNormTrain`` broadcasts the (size, 1, 1) stats against the flat
    running stats; ROADMAP Queue 3).  Per-activation statistics of (N, size)
    are the spatial statistics of (N, size, 1), so its twin is the JAX
    package's ``BatchNorm1D`` on that view, with the same scale draws."""

    def __init__(self, J, size):
        self.mod = J.BatchNorm1D(size)

    def __getattr__(self, name):
        return getattr(self.mod, name)

    def __call__(self, data):
        return self.mod(data.reshape(*data.shape, 1))

    def backward(self, grad):
        self.mod.backward(grad.reshape(*grad.shape, 1))


# each module of the family with an input shape
CASES = {
    "BatchNorm": (lambda M: M.BatchNorm(6) if M is T else _PerActivationTwin(M, 6), (8, 6)),
    "BatchNorm1D": (lambda M: M.BatchNorm1D(5), (4, 5, 7)),
    "BatchNorm2D": (lambda M: M.BatchNorm2D(5), (4, 5, 6, 6)),
    "BatchNorm3D": (lambda M: M.BatchNorm3D(3), (2, 3, 4, 4, 4)),
    "InstanceNorm2D": (lambda M: M.InstanceNorm2D(4), (3, 4, 5, 5)),
}
RUNNING = [name for name in CASES if name != "InstanceNorm2D"]


def _jax():
    """The JAX package's modules, containers and array upload; the twins
    skip where it does not import, as on the card's machine."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    from puzzlelib_tpu import containers, modules
    from puzzlelib_tpu.backend import gpuarray

    return modules, containers, gpuarray


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()

    return np.asarray(value.get() if hasattr(value, "get") else value, dtype=np.float32)


def _same(got, want):
    """Both as host arrays of one shape (the per-activation twin's trailing
    unit dim dropped)."""
    got, want = _host(got), _host(want)
    assert got.squeeze().shape == want.squeeze().shape
    return got.reshape(-1), want.reshape(-1)


def _close(got, want, bound=F32_BOUND):
    got, want = _same(got, want)
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def _relL2(got, want):
    got, want = _same(got, want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _twins(name, seed=0):
    factory, shape = CASES[name]
    J, _, _ = _jax()
    np.random.seed(seed)
    jmod = factory(J)
    np.random.seed(seed)
    tmod = factory(T)
    return jmod, tmod, shape


def _input(shape, seed=1):
    """A seeded input off zero mean and unit variance, so the stats move."""
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * 1.5 + 0.7).astype(np.float32)


def _setStats(jmod, tmod, seed=2):
    """The same non-trivial running stats in both twins."""
    rng = np.random.RandomState(seed)
    shape = tuple(tmod.mean.shape)
    table = {"mean": rng.randn(*shape).astype(np.float32), "var": rng.uniform(0.5, 2.0, shape).astype(np.float32)}

    jmod.mean.set(table["mean"].reshape(jmod.mean.shape))
    jmod.var.set(table["var"].reshape(jmod.var.shape))
    attrsFromNumpy(tmod, table)


def _runBoth(jmod, tmod, x, grad, jcast=None, tcast=None):
    """Forward and backward of both twins: ((jax out, in-grad), (port out,
    in-grad))."""
    _, _, jgpu = _jax()
    jx = x if jcast is None else x.astype(jcast)
    jg = grad if jcast is None else grad.astype(jcast)
    tx, tg = torch.from_numpy(x), torch.from_numpy(grad)
    if tcast is not None:
        tx, tg = tx.to(tcast), tg.to(tcast)

    jout = jmod(jgpu.to_gpu(jx))
    jmod.backward(jgpu.to_gpu(jg))
    tout = tmod(tx)
    tmod.backward(tg)
    return (jout, jmod.grad), (tout, tmod.grad)


# -- the family: forward, backward, running stats ------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def testNormTrainForwardBackwardTwin(name):
    """Train mode in f32: the output, the input gradient, the scale and bias
    gradients, and after the forward the running stats."""
    jmod, tmod, shape = _twins(name)
    x, grad = _input(shape), _input(shape, seed=3)

    (jout, jgrad), (tout, tgrad) = _runBoth(jmod, tmod, x, grad)

    _close(tout, jout)
    _close(tgrad, jgrad)
    for var in ("scale", "bias"):
        _close(tmod.vars[var].grad, jmod.vars[var].grad)

    if name in RUNNING:
        _close(tmod.mean, jmod.mean)
        _close(tmod.var, jmod.var)


@pytest.mark.parametrize("name", list(CASES))
def testNormBf16Twin(name):
    """``calcMode(bf16)`` keeps the scale, bias and running stats in f32, as
    the reference does; train-mode output and gradients within the bf16
    tier of the JAX module in bf16."""
    import ml_dtypes

    jmod, tmod, shape = _twins(name)
    jmod.calcMode(ml_dtypes.bfloat16)
    tmod.calcMode(torch.bfloat16)

    assert tmod.calctype == torch.bfloat16
    assert all(var.data.dtype == torch.float32 for var in tmod.vars.values())
    assert all(attr.dtype == torch.float32 for attr in tmod.attrs.values())

    x, grad = _input(shape), _input(shape, seed=3)
    (jout, jgrad), (tout, tgrad) = _runBoth(jmod, tmod, x, grad, jcast=ml_dtypes.bfloat16, tcast=torch.bfloat16)

    assert tout.dtype == tgrad.dtype == torch.bfloat16
    assert _relL2(tout, jout) <= BF16_BOUND
    assert _relL2(tgrad, jgrad) <= BF16_BOUND
    for var in ("scale", "bias"):
        assert tmod.vars[var].grad.dtype == torch.float32
        assert _relL2(tmod.vars[var].grad, jmod.vars[var].grad) <= BF16_BOUND

    if name in RUNNING:
        assert _relL2(tmod.mean, jmod.mean) <= BF16_BOUND
        assert _relL2(tmod.var, jmod.var) <= BF16_BOUND


@pytest.mark.parametrize("name", RUNNING)
def testNormEvalTwin(name):
    """Eval mode normalizes by the running stats: the output from the same
    non-trivial stats, in f32 and in bf16, which leaves the stats as they
    were."""
    import ml_dtypes

    jmod, tmod, shape = _twins(name)
    _setStats(jmod, tmod)
    jmod.evalMode()
    tmod.evalMode()
    x = _input(shape)
    _, _, jgpu = _jax()

    _close(tmod(torch.from_numpy(x)), jmod(jgpu.to_gpu(x)))

    stats = attrsToNumpy(tmod)
    jmod.calcMode(ml_dtypes.bfloat16)
    tmod.calcMode(torch.bfloat16)
    want = jmod(jgpu.to_gpu(x.astype(ml_dtypes.bfloat16)))
    assert _relL2(tmod(torch.from_numpy(x).to(torch.bfloat16)), want) <= BF16_BOUND

    for key, ary in attrsToNumpy(tmod).items():
        assert np.array_equal(ary, stats[key])


@pytest.mark.parametrize("name", RUNNING)
def testNormRunningStatsOverTwelveForwardsTwin(name):
    """Twelve train forwards on different inputs: the factor falls as
    1 / n and meets its 0.1 floor at the tenth; the running mean and the
    unbiased running variance follow the JAX module's after every one, in
    place."""
    jmod, tmod, shape = _twins(name)
    _, _, jgpu = _jax()
    addresses = [attr.data_ptr() for attr in tmod.attrs.values()]

    for step in range(12):
        x = _input(shape, seed=10 + step)
        jmod(jgpu.to_gpu(x))
        tmod(torch.from_numpy(x))

        _close(tmod.mean, jmod.mean)
        _close(tmod.var, jmod.var)

    assert tmod.numOfProps == jmod.numOfProps == 12
    assert [attr.data_ptr() for attr in tmod.attrs.values()] == addresses


@pytest.mark.parametrize("name", RUNNING)
def testNormFactorInsideAFusedStep(name):
    """Inside ``fusedctx`` the factor is max(initFactor / t, minFactor) of
    the step counter, a 0-d tensor: the running stats come out as the
    eager forward's with the same factor (before and past the floor), the
    module's own count does not move, and the stats stay where they were."""
    _, tmod, shape = _twins(name)
    _, eager, _ = _twins(name)
    x = torch.from_numpy(_input(shape))

    for t in (3, 20):
        eager.numOfProps = t - 1
        eager(x)

        addresses = [attr.data_ptr() for attr in tmod.attrs.values()]
        with fusedctx.activate({}, torch.tensor(float(t))):
            tmod(x)

        assert tmod.numOfProps == 0
        assert [attr.data_ptr() for attr in tmod.attrs.values()] == addresses
        assert torch.allclose(tmod.mean, eager.mean, rtol=1e-6, atol=1e-7)
        assert torch.allclose(tmod.var, eager.var, rtol=1e-6, atol=1e-7)


def testNormOpsAgainstFloat64():
    """``ops/norm.py`` against float64 numpy: the train output, the running
    stats blended with the unbiased variance, the backward; the saved stats
    rounded to x's type."""
    rng = np.random.RandomState(5)
    x = rng.randn(6, 3, 4, 4) * 2 + 1
    g = rng.randn(6, 3, 4, 4)
    scale, bias = rng.randn(3), rng.randn(3)
    runMean, runVar = torch.zeros(1, 3, 1, 1), torch.ones(1, 3, 1, 1)

    tx = torch.from_numpy(x).float()
    out, mean, invstd = norm.batchNormTrain(tx, torch.from_numpy(scale).float(), torch.from_numpy(bias).float(),
                                            runMean, runVar, 1e-5, 0.25)

    mu = x.mean(axis=(0, 2, 3))
    var = x.var(axis=(0, 2, 3))
    xhat = (x - mu.reshape(1, 3, 1, 1)) / np.sqrt(var.reshape(1, 3, 1, 1) + 1e-5)
    np.testing.assert_allclose(out.numpy(), xhat * scale.reshape(1, 3, 1, 1) + bias.reshape(1, 3, 1, 1),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(runMean.numpy().ravel(), 0.25 * mu, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(runVar.numpy().ravel(), 0.75 + 0.25 * var * 96 / 95, rtol=1e-5)

    dx, dscale, dbias = norm.batchNormBackward(torch.from_numpy(g).float(), tx, torch.from_numpy(scale).float(),
                                               mean, invstd, 1e-5)
    np.testing.assert_allclose(dbias.numpy(), g.sum(axis=(0, 2, 3)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dscale.numpy(), (g * xhat).sum(axis=(0, 2, 3)), rtol=1e-4, atol=1e-4)
    gs = g * scale.reshape(1, 3, 1, 1)
    want = (gs - gs.mean(axis=(0, 2, 3), keepdims=True) - xhat * (gs * xhat).mean(axis=(0, 2, 3), keepdims=True)) \
        / np.sqrt(var.reshape(1, 3, 1, 1) + 1e-5)
    np.testing.assert_allclose(dx.numpy(), want, rtol=1e-4, atol=1e-4)

    _, saved, _ = norm.batchNormTrain(tx.to(torch.bfloat16), torch.ones(3), torch.zeros(3), torch.zeros(3),
                                      torch.ones(3), 1e-5, 0.5)
    assert saved.dtype == torch.bfloat16


def testNormInplace():
    """An inplace batch norm refuses train mode, as the reference's does; in
    eval mode it writes its output into its input."""
    tmod = T.BatchNorm2D(3, inplace=True)
    x = torch.randn(2, 3, 4, 4) + 3

    with pytest.raises(ModuleError, match="inplace"):
        tmod(x)

    tmod.evalMode()
    out = tmod(x)
    assert out.data_ptr() == x.data_ptr()


def testNormShapeChecks():
    with pytest.raises(ModuleError, match="4d"):
        T.BatchNorm2D(3)(torch.zeros(2, 3, 4))

    with pytest.raises(ModuleError, match="maps"):
        T.BatchNorm1D(3)(torch.zeros(2, 4, 5))

    with pytest.raises(ModuleError, match="dimensions"):
        T.BatchNorm(3)(torch.zeros(2, 4))


# -- attributes: the module, convert, the fused collectors ------------------------------------------

def _convBn():
    np.random.seed(7)
    net = TC.Sequential(name="cb")
    net.append(T.Conv2D(3, 4, 3, pad=1, initscheme="he", name="conv1"))
    net.append(T.BatchNorm2D(4, name="bn1"))
    net.append(T.Activation(T.relu, name="relu1"))
    return net


def testAttributesAreBuffersAndTables():
    """``setAttr`` registers a buffer (``state_dict``, ``.to``), ``hasAttr``
    finds it, and ``getAttrTable`` names it as the reference's checkpoint
    does; ``attrsFromNumpy`` is strict and writes in place."""
    net = _convBn()
    bn = net["bn1"]

    assert bn.hasAttr("mean") and not bn.hasAttr("scale")
    assert set(net.state_dict()) == {"conv1.W", "conv1.b", "bn1.scale", "bn1.bias", "bn1.mean", "bn1.var"}
    assert set(net.getAttrTable()) == {"bn1.mean", "bn1.var"}

    table = {"bn1.mean": np.arange(4, dtype=np.float32).reshape(1, 4, 1, 1),
             "bn1.var": np.full((1, 4, 1, 1), 2.0, np.float32)}
    address = bn.mean.data_ptr()
    attrsFromNumpy(net, table)
    assert bn.mean.data_ptr() == address and np.array_equal(attrsToNumpy(net)["bn1.mean"], table["bn1.mean"])

    with pytest.raises(KeyError, match="missing"):
        attrsFromNumpy(net, {"bn1.mean": table["bn1.mean"]})

    with pytest.raises(KeyError, match="unknown"):
        attrsFromNumpy(net, dict(table, **{"bn2.mean": table["bn1.mean"]}))

    with pytest.raises(ValueError, match="shape"):
        attrsFromNumpy(net, dict(table, **{"bn1.var": np.ones(4, np.float32)}))


def testCalcModeKeepsNormStateF32AndTwoFlatBuffers():
    """In a bf16 net the batch norm's scale, bias and running stats stay
    f32, so MomentumSGD in global state keeps one flat buffer per type; the
    collectors walk the running stats as state and as eval input."""
    net = _convBn()
    net.calcMode(torch.bfloat16)
    opt = MomentumSGD(0.01, momRate=0.9)
    opt.setupOn(net, useGlobalState=True)

    assert set(opt.shParams) == {torch.bfloat16, torch.float32}
    assert opt.shParams[torch.float32].ary.numel() == 8

    bn = net["bn1"]
    for collect in (lambda: fused.collectStateBuffers(net, optimizer=opt), lambda: fused.collectEvalBuffers(net)):
        roots = {buf.data_ptr() for buf in collect()}
        assert bn.mean.data_ptr() in roots and bn.var.data_ptr() in roots


# -- Identity, Replicate, Parallel ---------------------------------------------------------------------

def _residual(M, C):
    """``tests/test_training.py`` ``testGraphMatchesSequentialAndParallel``'s
    fan-out and fan-in as a Sequential: inlin -> Replicate -> Parallel(a
    branch of two Linears, an Identity) -> Add -> Linear."""
    branch = C.Sequential()
    branch.append(M.Linear(6, 6, name="b1"))
    branch.append(M.Activation(M.relu, name="r1"))
    branch.append(M.Linear(6, 6, name="b2"))

    net = C.Sequential(name="res")
    net.append(M.Linear(6, 6, name="inlin"))
    net.append(M.Replicate(2))
    net.append(C.Parallel().append(branch).append(M.Identity()))
    net.append(M.Add())
    net.append(M.Linear(6, 3, name="out"))
    return net


def testReplicateParallelIdentityTwin():
    """Forward, input gradient and every parameter gradient of the residual
    fan-out / fan-in against the JAX package's, and against the same sum by
    hand."""
    J, JC, jgpu = _jax()
    np.random.seed(5)
    jnet = _residual(J, JC)
    tnet = _residual(T, TC)
    paramsFromNumpy(tnet, {name: var.data.get() for var, names in jnet.getVarTable().items() for name in names})

    rng = np.random.RandomState(6)
    x = rng.randn(4, 6).astype(np.float32)
    g = rng.randn(4, 3).astype(np.float32)

    _close(tnet(torch.from_numpy(x)), jnet(jgpu.to_gpu(x)))
    jnet.backward(jgpu.to_gpu(g))
    tnet.backward(torch.from_numpy(g))
    _close(tnet.grad, jnet.grad)

    for var, names in jnet.getVarTable().items():
        _close(tnet.getVar(names[0]).grad, var.grad)

    hidden = tnet["inlin"].data
    assert torch.allclose(tnet[3].data, tnet[2][0].data + hidden)
    assert tnet[2][1].data is hidden and tnet[1].data[0] is tnet[1].data[1]


def testReplicateSumsInTheInputsType():
    rep = T.Replicate(3)
    rep.calcMode(torch.bfloat16)
    x = torch.ones(2, 2, dtype=torch.bfloat16)
    assert rep(x) == [x, x, x]

    grads = [torch.full((2, 2), v, dtype=torch.bfloat16) for v in (1.0, 2.0, 1.0 / 256)]
    rep.backward(grads)
    assert rep.grad.dtype == torch.bfloat16 and torch.equal(rep.grad, (grads[0] + grads[1]) + grads[2])
    assert rep.dataShapeFrom((2, 2)) == [(2, 2)] * 3 and rep.gradShapeFrom([(2, 2)] * 3) == (2, 2)


def testParallelContainerProtocol():
    """Indexing, slicing, ``pop``, the shape chains, the branch's error with
    its index, and the backward's momentum default of 1.0: a second backward
    adds to the parameter gradients."""
    par = TC.Parallel().append(T.Linear(4, 2, name="a")).append(T.Identity(name="i"))
    assert par[0].name == "a" and par.getByIndex(1).name == "i" and par["a"] is par[0]
    assert [m.name for m in par[0:1].graph] == ["a"]
    assert par.dataShapeFrom([(3, 4), (3, 5)]) == [(3, 2), (3, 5)]
    assert par.gradShapeFrom([(3, 2), (3, 5)]) == [(3, 4), (3, 5)]

    x = [torch.randn(3, 4), torch.randn(3, 5)]
    out = par(x)
    assert out[1] is x[1]

    grads = [torch.ones(3, 2), torch.ones(3, 5)]
    par.backward(grads)
    once = par[0].vars["W"].grad.clone()
    par.backward(grads)
    assert torch.allclose(par[0].vars["W"].grad, 2 * once)

    with pytest.raises(ModuleError, match="Data error in module 0"):
        par([torch.randn(3, 5), torch.randn(3, 5)])

    assert par.pop().name == "i" and len(par.graph) == 1
