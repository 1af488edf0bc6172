"""Backward twins of the port's modules, cost and optimizer against the JAX
package's.

Each twin builds the JAX module and the port's from the same numpy seed,
runs the same numpy input forward through both, then the same output
gradient backward (``backward``: ``updateGrad`` and ``accGradParams``), and
compares the input gradients and the accumulated parameter gradients.  f32
within 1e-5 of max|ref| (the reference's f32 tier), bf16 within 5e-2 (its
bf16 tier).
"""

import numpy as np
import pytest
import torch

# every test here is a twin: skip where the JAX package does not import, as
# on the card's machine
pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")

import ml_dtypes  # noqa: E402

from puzzlelib_tpu.backend import gpuarray as jgpu  # noqa: E402
from puzzlelib_tpu import modules as J  # noqa: E402
from puzzlelib_tpu import cost as JCost  # noqa: E402
from puzzlelib_tpu import optimizers as JOpt  # noqa: E402

from puzzlelib_tpu_torch import config as TConfig  # noqa: E402
from puzzlelib_tpu_torch import modules as T  # noqa: E402
from puzzlelib_tpu_torch import cost as TCost  # noqa: E402
from puzzlelib_tpu_torch import optimizers as TOpt  # noqa: E402
from puzzlelib_tpu_torch.convert import optimizerStateFromNumpy, optimizerStateToNumpy  # noqa: E402


BOUNDS = {"f32": 1e-5, "bf16": 5e-2}
_TYPES = {"f32": (np.float32, torch.float32), "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _onCpu(monkeypatch):
    """The twins compare on the CPU, also on a machine with a card."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _twins(factory, seed=0):
    np.random.seed(seed)
    jmod = factory(J)
    np.random.seed(seed)
    tmod = factory(T)
    return jmod, tmod


def _host(tensor):
    return tensor.detach().float().numpy()


def _close(got, want, bound):
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def _setVars(jmod, tmod, seed, grads=False):
    """Random values of the parameters (or, with ``grads``, of the gradient
    buffers) in both twins, in each module's type."""
    rng = np.random.RandomState(seed)

    for name, jvar in jmod.vars.items():
        tvar = tmod.vars[name]
        ary = (rng.randn(*jvar.data.shape) * 0.3).astype(np.float32)

        if grads:
            jvar.grad.set(ary.astype(jvar.grad.dtype))
            tvar.grad.copy_(torch.from_numpy(ary))
        else:
            jvar.data.set(ary.astype(jvar.data.dtype))
            tvar.data.copy_(torch.from_numpy(ary))


def _backwardTwin(jmod, tmod, x, dtype, scale=1.0, momentum=0.0, seed=20):
    """Forward x and backward a random output gradient through both twins in
    ``dtype``; returns (input gradients, {var name: (port grad, JAX grad)})."""
    npT, torchT = _TYPES[dtype]
    if dtype == "bf16":
        jmod.calcMode(npT)
        tmod.calcMode(torchT)

    _setVars(jmod, tmod, seed)
    if momentum != 0.0:
        _setVars(jmod, tmod, seed + 1, grads=True)

    jy = jmod(jgpu.to_gpu(x.astype(npT)))
    ty = tmod(torch.from_numpy(x).to(torchT))
    _close(_host(ty), jy.get(), BOUNDS[dtype])

    g = np.random.RandomState(seed + 2).randn(*ty.shape).astype(np.float32)
    jmod.backward(jgpu.to_gpu(g.astype(npT)), scale=scale, momentum=momentum)
    tmod.backward(torch.from_numpy(g).to(torchT), scale=scale, momentum=momentum)

    assert tmod.grad.dtype == torchT and tuple(tmod.grad.shape) == tuple(x.shape)
    grads = {name: (_host(tmod.vars[name].grad), var.grad.get()) for name, var in jmod.vars.items()}
    return (_host(tmod.grad), jmod.grad.get()), grads


_CONV_CASES = [(3, 1, 1, True, (9, 7)), (3, 1, 0, False, (8, 8)), (3, 2, 1, True, (11, 10)), (3, 2, 0, True, (9, 9)),
               (1, 1, 0, False, (5, 6))]


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
@pytest.mark.parametrize("size, stride, pad, bias, hw", _CONV_CASES)
def testConv2DBackwardTwin(size, stride, pad, bias, hw, dtype):
    """updateGrad through the transposed conv (the stride-1 route and the
    strided remainder, whose odd sizes need the stride adjustment) and
    accGradParams (bwd-filter and the bias sum)."""
    jmod, tmod = _twins(lambda M: M.Conv2D(4, 6, size, stride=stride, pad=pad, useBias=bias, initscheme="he"))
    x = np.random.RandomState(3).randn(2, 4, *hw).astype(np.float32)

    (got, want), grads = _backwardTwin(jmod, tmod, x, dtype)

    _close(got, want, BOUNDS[dtype])
    assert sorted(grads) == (["W", "b"] if bias else ["W"])
    for tgrad, jgrad in grads.values():
        _close(tgrad, jgrad, BOUNDS[dtype])

    assert tmod.gradShapeFrom(tuple(tmod.data.shape)) == jmod.gradShapeFrom(tuple(tmod.data.shape))


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
def testConv2DAccumulatesWithScaleAndMomentum(dtype):
    """wgrad = dw * scale + wgrad * momentum, written into the buffers."""
    jmod, tmod = _twins(lambda M: M.Conv2D(3, 5, 3, pad=1, initscheme="he"))
    buffers = {name: var.grad for name, var in tmod.vars.items()}
    x = np.random.RandomState(4).randn(2, 3, 6, 6).astype(np.float32)

    _, grads = _backwardTwin(jmod, tmod, x, dtype, scale=0.5, momentum=0.7)

    for name, (tgrad, jgrad) in grads.items():
        _close(tgrad, jgrad, BOUNDS[dtype])

    if dtype == "f32":   # bf16's calcMode made new buffers
        assert all(tmod.vars[name].grad is buf for name, buf in buffers.items())


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
@pytest.mark.parametrize("momentum", [0.0, 1.0])
def testLinearBackwardTwin(momentum, dtype):
    """The transposed products of the input gradient and of dW, and the
    bias sum, with and without accumulation into the buffers."""
    jmod, tmod = _twins(lambda M: M.Linear(12, 7, initscheme="xavier"))
    x = np.random.RandomState(5).randn(5, 12).astype(np.float32)

    (got, want), grads = _backwardTwin(jmod, tmod, x, dtype, momentum=momentum)

    _close(got, want, BOUNDS[dtype])
    for tgrad, jgrad in grads.values():
        _close(tgrad, jgrad, BOUNDS[dtype])


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
def testReluBackwardTwin(dtype):
    """The derivative from the output: zero where the output is zero."""
    jmod, tmod = _twins(lambda M: M.Activation(M.relu))
    x = np.random.RandomState(6).randn(3, 4, 5).astype(np.float32)

    (got, want), _ = _backwardTwin(jmod, tmod, x, dtype)
    _close(got, want, BOUNDS[dtype])


def testReluInplaceBackwardWritesOverTheIncomingGradient():
    mod = T.Activation(T.relu, inplace=True)
    mod(torch.tensor([[-1.0, 2.0, 0.0]]))

    grad = torch.tensor([[5.0, 6.0, 7.0]])
    mod.backward(grad)

    assert mod.grad is grad and grad.tolist() == [[0.0, 6.0, 0.0]]


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
@pytest.mark.parametrize("size, stride, pad", [(2, 2, 0), (3, 2, 1), (3, 1, 1)])
def testMaxPool2DBackwardTwin(size, stride, pad, dtype):
    """Each window's gradient goes to its first maximum in window order, as
    the reference's select-and-scatter sends it: the input is relu'd, so many
    windows hold ties, and one block is all zeros."""
    jmod, tmod = _twins(lambda M: M.MaxPool2D(size, stride, pad))
    x = np.maximum(np.random.RandomState(7).randn(2, 3, 9, 8), 0).astype(np.float32)
    x[0, 0, :4, :4] = 0.0

    (got, want), _ = _backwardTwin(jmod, tmod, x, dtype)

    _close(got, want, BOUNDS[dtype])
    if dtype == "f32":   # sums of routed output gradients: the same cells, exact
        assert np.array_equal(got, want)
    assert tmod.gradShapeFrom(tuple(tmod.data.shape)) == jmod.gradShapeFrom(tuple(tmod.data.shape))


def testMaxPoolAllZeroWindowRoutesToItsFirstCell():
    mod = T.MaxPool2D(2, 2)
    mod(torch.zeros(1, 1, 2, 2))
    mod.backward(torch.ones(1, 1, 1, 1))

    assert mod.grad.flatten().tolist() == [1.0, 0.0, 0.0, 0.0]


def testFlattenBackwardTwin():
    jmod, tmod = _twins(lambda M: M.Flatten())
    x = np.random.RandomState(8).randn(3, 4, 5, 2).astype(np.float32)

    (got, want), _ = _backwardTwin(jmod, tmod, x, "f32")

    assert np.array_equal(got, want)
    assert tmod.gradShapeFrom((3, 40)) == jmod.gradShapeFrom((3, 40)) == (3, 4, 5, 2)


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
@pytest.mark.parametrize("shape", [(6, 10), (2, 5, 3, 4)])
def testSoftMaxBackwardTwin(shape, dtype):
    jmod, tmod = _twins(lambda M: M.SoftMax())
    x = (np.random.RandomState(9).randn(*shape) * 3).astype(np.float32)

    (got, want), _ = _backwardTwin(jmod, tmod, x, dtype)
    _close(got, want, BOUNDS[dtype])


def testFoldParamGradAndUpdateParamsTwin():
    """``foldParamGrad`` (grad = scale * new + momentum * grad) and the plain
    ``updateParams`` step (data += learnRate * grad), both in place."""
    jmod, tmod = _twins(lambda M: M.Linear(4, 3, initscheme="he"))
    _setVars(jmod, tmod, 30, grads=True)
    buffer = tmod.vars["W"].grad

    new = np.random.RandomState(31).randn(4, 3).astype(np.float32)
    jmod.foldParamGrad("W", jgpu.to_gpu(new), scale=0.5, momentum=0.25)
    tmod.foldParamGrad("W", torch.from_numpy(new), scale=0.5, momentum=0.25)

    assert tmod.vars["W"].grad is buffer
    _close(_host(buffer), jmod.vars["W"].grad.get(), BOUNDS["f32"])

    jmod.updateParams(0.1)
    tmod.updateParams(0.1)
    for name, var in jmod.vars.items():
        _close(_host(tmod.vars[name].data), var.data.get(), BOUNDS["f32"])


def testBackwardChecksTheGradient():
    mod = T.Conv2D(3, 4, 3, pad=1, initscheme="he")
    mod(torch.zeros(1, 3, 5, 5))

    with pytest.raises(T.ModuleError):
        mod.backward(torch.zeros(1, 5, 5, 5))

    with pytest.raises(T.ModuleError):
        mod.backward(torch.zeros(1, 4, 5, 5, dtype=torch.float64))


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
@pytest.mark.parametrize("shape", [(6, 10), (3, 7, 2, 3)])
def testCrossEntropyTwin(shape, dtype):
    """The error (f32, normalised by the spatial extent, read per sample) and
    the gradient (onehot - softmax) / batch in the scores' type."""
    npT, torchT = _TYPES[dtype]
    rng = np.random.RandomState(10)
    scores = (rng.randn(*shape) * 2).astype(np.float32)
    labels = rng.randint(0, shape[1], size=(shape[0], ) + shape[2:]).astype(np.int32)

    jcost, tcost = JCost.CrossEntropy(), TCost.CrossEntropy()
    jerr, jgrad = jcost(jgpu.to_gpu(scores.astype(npT)), jgpu.to_gpu(labels))
    terr, tgrad = tcost(torch.from_numpy(scores).to(torchT), torch.from_numpy(labels))

    assert tgrad.dtype == torchT
    assert abs(terr - jerr) <= BOUNDS[dtype] * abs(jerr)
    _close(_host(tgrad), jgrad.get(), BOUNDS[dtype])

    # a second batch accumulates on the device
    tcost(torch.from_numpy(scores).to(torchT), torch.from_numpy(labels), queryError=False)
    assert tcost.numOfSamples == 2 * shape[0] and abs(tcost.getMeanError() - terr) <= 1e-6 * abs(terr)


def testCrossEntropyVerifiesLabels(monkeypatch):
    monkeypatch.setattr(TConfig, "verifyData", True)
    scores = torch.zeros(2, 3)

    for bad in ([0, 3], [-1, 1]):
        with pytest.raises(TCost.CostError):
            TCost.CrossEntropy()(scores, torch.tensor(bad, dtype=torch.int32))

    with pytest.raises(TCost.CostError):
        TCost.CrossEntropy()(scores, torch.tensor([0, 1], dtype=torch.int64))


def _optTwins(useGlobalState, dtype, seed=11):
    """Two-layer twins with random gradients, each under a MomentumSGD."""
    def factory(M):
        from puzzlelib_tpu import containers as JC
        from puzzlelib_tpu_torch import containers as TC

        net = (JC if M is J else TC).Sequential(name="net")
        net.append(M.Conv2D(2, 3, 3, pad=1, initscheme="he", name="c"))
        net.append(M.Flatten())
        net.append(M.Linear(3 * 4 * 4, 5, initscheme="he", name="fc"))
        return net

    npT, torchT = _TYPES[dtype]
    jnet, tnet = _twins(factory, seed)
    if dtype == "bf16":
        jnet.calcMode(npT)
        tnet.calcMode(torchT)

    jopt, topt = JOpt.MomentumSGD(0.1, momRate=0.9), TOpt.MomentumSGD(0.1, momRate=0.9)
    jopt.setupOn(jnet, useGlobalState=useGlobalState)
    topt.setupOn(tnet, useGlobalState=useGlobalState)

    rng = np.random.RandomState(seed + 1)
    for var, names in jnet.getVarTable().items():
        ary = rng.randn(*var.data.shape).astype(np.float32)
        var.grad.set(ary.astype(var.grad.dtype))
        tnet.getVar(names[0]).grad.copy_(torch.from_numpy(ary))

    return jnet, tnet, jopt, topt


def _jaxStateTable(jopt):
    """The JAX optimizer's state, named as its ``save`` names the datasets."""
    return {"%s.%s" % (key, entity): np.asarray(tensor.get(), np.float32)
            for key, state in jopt.states.items() for entity, tensor in state.items()}


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
@pytest.mark.parametrize("useGlobalState", [True, False])
def testMomentumSGDStepTwin(useGlobalState, dtype):
    """Two updates from the same gradients and a mid-training momentum
    carried across by ``optimizerStateFromNumpy``: the same parameters and
    momentum, in the parameters' type; the state table names match the
    reference's."""
    jnet, tnet, jopt, topt = _optTwins(useGlobalState, dtype)

    rng = np.random.RandomState(12)
    table = {name: (rng.randn(*ary.shape) * 0.1).astype(np.float32) for name, ary in _jaxStateTable(jopt).items()}
    for key, state in jopt.states.items():
        state["mom"].set(table["%s.mom" % key].astype(state["mom"].dtype))

    assert set(optimizerStateToNumpy(topt)) == set(table)
    optimizerStateFromNumpy(topt, table)

    for _ in range(2):
        jopt.update()
        topt.update()

    assert topt.t == jopt.t == 2
    for var, names in jnet.getVarTable().items():
        _close(_host(tnet.getVar(names[0]).data), var.data.get(), BOUNDS[dtype])

    got, want = optimizerStateToNumpy(topt), _jaxStateTable(jopt)
    for name in want:
        _close(got[name], want[name], BOUNDS[dtype])


def testOptimizerStateFromNumpyRejectsMismatches():
    _, _, jopt, topt = _optTwins(True, "f32")
    table = _jaxStateTable(jopt)
    name = next(iter(table))

    with pytest.raises(KeyError):
        optimizerStateFromNumpy(topt, dict(table, extra=np.zeros(1, np.float32)))

    with pytest.raises(ValueError):
        optimizerStateFromNumpy(topt, dict(table, **{name: np.zeros(3, np.float32)}))


def testGlobalStateVariablesAreViewsOfThePacks():
    """After ``setupOn(useGlobalState=True)`` every variable and gradient is
    a view of its dtype's flat tensor, the net's registered parameters are
    those views, and ``zeroGradParams`` clears them through the pack."""
    _, tnet, _, topt = _optTwins(True, "f32")
    pack, gradPack = topt.shParams[torch.float32].ary, topt.shGrads[torch.float32].ary

    for var in tnet.getVarTable():
        assert var.data.untyped_storage().data_ptr() == pack.untyped_storage().data_ptr()
        assert var.grad.untyped_storage().data_ptr() == gradPack.untyped_storage().data_ptr()

    assert all(p.untyped_storage().data_ptr() == pack.untyped_storage().data_ptr() for p in tnet.parameters())
    assert pack.numel() == sum(-(-var.data.numel() // 4) * 4 for var in tnet.getVarTable())

    topt.zeroGradParams()
    assert all((var.grad == 0).all() for var in tnet.getVarTable())
