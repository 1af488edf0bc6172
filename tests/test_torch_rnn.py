"""The RNN against the JAX package: ``RNN`` in its four modes, one and two
directions, with and without ``getSequences``, on two levels with the JAX
package's dropout masks injected into the port; the backend's bf16 path;
the flat-weight layouts (``converter.rnnweights``); the GRU gradient check;
and a fused LSTM step trained with ``MSE``.

Both packages draw the same flat weight from one ``np.random.seed``.  The
JAX package draws its dropout masks from its own keys: each twin reads the
JAX module's masks back (``jax.random.bernoulli`` on the key of its last
forward, per level, as ``backend/rnn.py`` draws them) and hands them to the
port's ``_drawMasks``.  f32 is held within 1e-5 of max(1, max |want|) (the
reference's f32 tier), bf16 within 5e-2 (its bf16 tier).  The card-only
cases (``cuda`` marker) hold each mode on the card to the same module on the
CPU, and replay a fused RNN step."""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch.backend import rnn as trnn
from puzzlelib_tpu_torch.containers import Sequential as TSequential
from puzzlelib_tpu_torch.converter.rnnweights import convertRnnWeights, cudnnRnnLayout
from puzzlelib_tpu_torch.cost import MSE as TMSE
from puzzlelib_tpu_torch.fused import FusedStep as TFusedStep
from puzzlelib_tpu_torch.modules import Linear as TLinear
from puzzlelib_tpu_torch.modules import RNN as TRNN
from puzzlelib_tpu_torch.modules import ModuleError
from puzzlelib_tpu_torch.optimizers import Adam as TAdam


BOUNDS = {"f32": 1e-5, "bf16": 5e-2}
MODES = ["relu", "tanh", "lstm", "gru"]


def _jax():
    """The JAX package's pieces; the twins skip where it does not import, as
    on the card's machine."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    import jax
    from puzzlelib_tpu import containers, cost, modules, optimizers
    from puzzlelib_tpu.backend import gpuarray

    return jax, modules, containers, cost, optimizers, gpuarray


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card (the card-only
    cases set "cuda" themselves)."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()

    return np.asarray(value.get() if hasattr(value, "get") else value, dtype=np.float32)


def _close(got, want, bound=BOUNDS["f32"]):
    got, want = _host(got), _host(want)
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def _jaxMasks(desc, shape):
    """The keep masks the JAX package's last train forward drew, per level
    below the last (``backend/rnn.py`` ``_rnnCore``)."""
    jax = _jax()[0]
    if desc._lastDropout == 0.0:
        return None

    return [np.asarray(jax.random.bernoulli(jax.random.fold_in(desc._lastKey, level), 1.0 - desc._lastDropout,
                                            shape)) for level in range(desc.layers - 1)]


def _injectMasks(tdesc, masks):
    tdesc._drawMasks = lambda shape, device: [torch.from_numpy(np.array(m)).to(device) for m in masks]


def _each(fn, tree):
    return [_each(fn, node) for node in tree] if isinstance(tree, list) else fn(tree)


# -- the module ------------------------------------------------------------------------

@pytest.mark.parametrize("getSequences", [False, True])
@pytest.mark.parametrize("direction", ["uni", "bi"])
@pytest.mark.parametrize("mode", MODES)
def testRnnTwin(mode, direction, getSequences):
    """Two levels of 5 hidden units over (T, B, 6) = (7, 3, 6) with dropout
    0.3 between them: the flat weight from one seed, the output, the input
    gradient and the flat weight's gradient."""
    _, J, _, _, _, jgpu = _jax()
    kwargs = dict(layers=2, mode=mode, direction=direction, dropout=0.3, getSequences=getSequences)

    np.random.seed(11)
    jmod = J.RNN(6, 5, **kwargs)
    np.random.seed(11)
    tmod = TRNN(6, 5, **kwargs)
    assert np.array_equal(jmod.W.get(), tmod.W.numpy())

    # the JAX package's masks come from its global generator's next key:
    # seeded, they do not depend on the tests run before in the process
    from puzzlelib_tpu.rng import globalRng
    globalRng.seed(5)

    x = np.random.RandomState(1).randn(7, 3, 6).astype(np.float32)
    jout = jmod(jgpu.to_gpu(x))
    _injectMasks(tmod.descRnn, _jaxMasks(jmod.descRnn, (7, 3, 5 * (2 if direction == "bi" else 1))))
    tout = tmod(torch.from_numpy(x))

    rng = np.random.RandomState(2)
    grad = _each(lambda out: rng.randn(*out.shape).astype(np.float32), jout)
    jmod.backward(_each(jgpu.to_gpu, grad))
    tmod.backward(_each(torch.from_numpy, grad))

    _each(lambda pair: _close(*pair), list(zip(tout, jout)) if isinstance(jout, list) else (tout, jout))
    _close(tmod.grad, jmod.grad)
    _close(tmod.vars["W"].grad, jmod.vars["W"].grad)


def testReluRnnSplitsTheGradientAtZeroAsJax():
    """A relu step whose pre-activation is exactly zero (zero data, zero
    biases) takes half the gradient, as ``jnp.maximum`` gives it in the JAX
    package, where ``torch.relu`` would give none."""
    _, J, _, _, _, jgpu = _jax()

    np.random.seed(14)
    jmod = J.RNN(3, 4, mode="relu", getSequences=True)
    np.random.seed(14)
    tmod = TRNN(3, 4, mode="relu", getSequences=True)

    x = np.zeros((2, 2, 3), np.float32)
    x[1] = np.random.RandomState(3).randn(2, 3)
    grad = np.random.RandomState(4).randn(2, 2, 4).astype(np.float32)

    jmod(jgpu.to_gpu(x))
    tmod(torch.from_numpy(x))
    jmod.backward(jgpu.to_gpu(grad))
    tmod.backward(torch.from_numpy(grad))

    _close(tmod.grad, jmod.grad)
    _close(tmod.vars["W"].grad, jmod.vars["W"].grad)
    assert tmod.grad[0].abs().sum() > 0


def testRnnShapesAndEvalMode():
    """The output shapes of both directions with and without sequences, the
    bidirectional halves (the forward direction's last step, the backward
    direction's first), no dropout in eval mode, and the f32-only
    ``calcMode`` of the reference."""
    np.random.seed(3)
    bi = TRNN(4, 3, layers=2, mode="lstm", direction="bi", dropout=0.5)
    x = torch.from_numpy(np.random.RandomState(4).randn(5, 2, 4).astype(np.float32))

    fwd, bwd = bi(x)
    assert fwd.shape == bwd.shape == (2, 3)
    assert bi.dataShapeFrom((5, 2, 4)) == [(2, 3), (2, 3)]
    assert torch.equal(fwd, bi.fulldata[-1, :, :3]) and torch.equal(bwd, bi.fulldata[0, :, 3:])

    bi.evalMode()
    first = bi(x)[0].clone()
    assert torch.equal(bi(x)[0], first)

    with pytest.raises(ModuleError):
        bi.calcMode(torch.bfloat16)

    with pytest.raises(ModuleError):
        bi(torch.zeros(5, 2, 3))


@pytest.mark.parametrize("mode", MODES)
def testRnnBackendBf16Twin(mode):
    """The backend on bf16 data with the f32 flat weight, two levels and two
    directions, against the JAX package's jitted forward and VJPs: computed
    in f32, the output and the input gradient in bf16, the weight's gradient
    in f32."""
    jax = _jax()[0]
    import ml_dtypes
    from puzzlelib_tpu.backend import rnn as jrnn

    insize, hsize, layers = 6, 5, 2
    desc = trnn.RnnDesc(insize, hsize, layers, mode, "bi")
    W = np.random.RandomState(5).randn(desc.wsize).astype(np.float32) * 0.3
    x = np.random.RandomState(6).randn(4, 3, insize).astype(np.float32)
    grad = np.random.RandomState(7).randn(4, 3, 2 * hsize).astype(np.float32)

    args = (insize, hsize, layers, mode, "bi", 0.0)
    key = jax.random.key(0)
    xb, gb = x.astype(ml_dtypes.bfloat16), grad.astype(ml_dtypes.bfloat16)
    jout = jrnn._rnnForward(xb, W, key, *args)
    jdx = jrnn._rnnBackwardData(xb, W, key, gb, *args)
    jdw = jrnn._rnnBackwardParams(xb, W, key, gb, *args)

    tout, _ = desc.forward(torch.from_numpy(x).bfloat16(), torch.from_numpy(W))
    tdx, tdw = desc.backward(torch.from_numpy(grad).bfloat16())

    assert tout.dtype == tdx.dtype == torch.bfloat16 and tdw.dtype == torch.float32
    _close(tout, np.asarray(jout, np.float32), BOUNDS["bf16"])
    _close(tdx, np.asarray(jdx, np.float32), BOUNDS["bf16"])
    _close(tdw, np.asarray(jdw, np.float32), BOUNDS["bf16"])


def testRnnWeightGradWithoutInputGradient():
    """``updGrad=False`` on a net's first module: ``accGradParams`` takes
    the weights' gradient alone, the same as after ``updateGrad``."""
    x = torch.from_numpy(np.random.RandomState(8).randn(6, 2, 4).astype(np.float32))
    grad = torch.from_numpy(np.random.RandomState(9).randn(2, 3).astype(np.float32))

    grads = []
    for updGrad in (True, False):
        np.random.seed(12)
        mod = TRNN(4, 3, mode="gru")
        mod(x)
        mod.backward(grad, updGrad=updGrad)
        grads.append(mod.vars["W"].grad.clone())
        assert (mod.grad is None) != updGrad

    assert torch.equal(grads[0], grads[1])


# -- the layouts ------------------------------------------------------------------------

def testRnnWeightLayoutConversion():
    """The twin of the JAX package's ``testRnnWeightLayoutConversion``:
    cuDNN blob -> the port's layout -> cuDNN is exact, the converted blob
    shows the same named views, and both packages convert alike."""
    pytest.importorskip("puzzlelib_tpu.converter.rnnweights", reason="the twins need the JAX package")
    from puzzlelib_tpu.converter import rnnweights as jweights

    for mode, direction, layers in [("lstm", "uni", 2), ("gru", "bi", 2), ("tanh", "uni", 1), ("relu", "bi", 1)]:
        insize, hsize = 6, 5
        entries, wsize = cudnnRnnLayout(mode, insize, hsize, layers, direction)
        assert (entries, wsize) == jweights.cudnnRnnLayout(mode, insize, hsize, layers, direction)

        cudnnBlob = np.random.RandomState(3).randn(wsize).astype(np.float32)

        native = convertRnnWeights(cudnnBlob, mode, insize, hsize, layers, direction, source="cudnn")
        back = convertRnnWeights(native, mode, insize, hsize, layers, direction, source="native")
        assert np.array_equal(back, cudnnBlob), (mode, direction)
        assert np.array_equal(native, jweights.convertRnnWeights(cudnnBlob, mode, insize, hsize, layers, direction))

        desc = trnn.RnnDesc(insize, hsize, layers, mode, direction)
        views = desc.acquireParams(torch.from_numpy(native))
        for layer, name, offset, shape in entries:
            expect = cudnnBlob[offset:offset + int(np.prod(shape))].reshape(shape)
            assert np.array_equal(views[layer][name].numpy(), expect), (mode, layer, name)

    with pytest.raises(ValueError):
        convertRnnWeights(np.zeros(3, np.float32), "lstm", 6, 5, 1)


def testRnnLayoutMatchesJax():
    """Every mode and direction on two levels: the port's flat layout is the
    JAX package's, offset for offset."""
    pytest.importorskip("puzzlelib_tpu.backend.rnn", reason="the twins need the JAX package")
    from puzzlelib_tpu.backend import rnn as jrnn

    for mode in MODES:
        for direction in ("uni", "bi"):
            jdesc, tdesc = jrnn.RnnDesc(6, 5, 2, mode, direction), trnn.RnnDesc(6, 5, 2, mode, direction)
            assert tdesc.layout == jdesc.layout and tdesc.wsize == jdesc.wsize


# -- gradient check and training -----------------------------------------------------------

def _gradientCheck(mod, data, target, cost, h=1e-3):
    """The port's counterpart of ``testlib/gradientcheck.gradientCheck``:
    per-parameter relative central-difference errors against the analytic
    gradient of one backward (``updGrad=False``)."""
    _, grad = cost(mod(data), target)
    mod.backward(grad, updGrad=False)

    relerrors = []
    for var in mod.getVarTable():
        theta = var.data.detach().clone()
        analytic = -var.grad.reshape(-1)

        for i in range(theta.numel()):
            losses = []
            for step in (h, -h):
                perturbed = theta.clone()
                perturbed.view(-1)[i] += step
                var.data.copy_(perturbed)
                losses.append(cost(mod(data), target)[0])

            var.data.copy_(theta)
            numeric = (losses[0] - losses[1]) / (2.0 * h)
            relerrors.append(abs((numeric - analytic[i].item()) / (analytic[i].item() + h)))

    return relerrors


def testRnnGradientsTwin():
    """The twin of the JAX package's ``testRnnGradients``: a GRU and a
    Linear trained with ``MSE`` from ``np.random.seed(2)``, the analytic
    gradients of both packages equal and the port's within 1e-2 (median) of
    central differences."""
    _, J, JC, JCost, _, jgpu = _jax()

    np.random.seed(2)
    jnet = JC.Sequential()
    jnet.append(J.RNN(4, 5, mode="gru"))
    jnet.append(J.Linear(5, 2))
    data = np.random.randn(3, 2, 4).astype(np.float32)
    target = np.random.randn(2, 2).astype(np.float32)

    np.random.seed(2)
    tnet = TSequential()
    tnet.append(TRNN(4, 5, mode="gru"))
    tnet.append(TLinear(5, 2))

    jcost, tcost = JCost.MSE(), TMSE()
    jerr, jgrad = jcost(jnet(jgpu.to_gpu(data)), jgpu.to_gpu(target))
    terr, tgrad = tcost(tnet(torch.from_numpy(data)), torch.from_numpy(target))
    assert terr == pytest.approx(jerr, rel=1e-5)
    _close(tgrad, jgrad)

    jnet.backward(jgrad, updGrad=False)
    tnet.backward(tgrad, updGrad=False)
    for module, name in ((0, "W"), (1, "W"), (1, "b")):
        _close(tnet.graph[module].vars[name].grad, jnet.graph[module].vars[name].grad)
        tnet.graph[module].vars[name].grad.zero_()

    errors = _gradientCheck(tnet, torch.from_numpy(data), torch.from_numpy(target), TMSE())
    assert np.median(errors) < 1e-2, np.median(errors)


def testFusedLstmStepTwin():
    """The twin of the JAX package's ``testFusedTrainerWithRnnAndBf16Mode``
    (its RNN part): an LSTM and a Linear with ``Adam(0.01)`` in global state
    and ``MSE``, 10 fused steps on one batch, the losses of both packages
    step by step within 1e-5 (the port's step runs eagerly on the CPU) and
    falling."""
    _, J, JC, JCost, JOpt, _ = _jax()
    from puzzlelib_tpu.fused import FusedStep as JFusedStep

    np.random.seed(20)
    jnet = JC.Sequential()
    jnet.append(J.RNN(6, 8, mode="lstm"))
    jnet.append(J.Linear(8, 4))
    jopt = JOpt.Adam(alpha=0.01)
    jopt.setupOn(jnet, useGlobalState=True)
    jcost = JCost.MSE()
    jstep = JFusedStep(jnet, jcost, jopt)

    data = np.random.randn(5, 3, 6).astype(np.float32)
    target = np.random.randn(3, 4).astype(np.float32)

    np.random.seed(20)
    tnet = TSequential()
    tnet.append(TRNN(6, 8, mode="lstm"))
    tnet.append(TLinear(8, 4))
    topt = TAdam(alpha=0.01)
    topt.setupOn(tnet, useGlobalState=True)
    tcost = TMSE()
    tstep = TFusedStep(tnet, tcost, topt)

    jlosses, tlosses = [], []
    for _ in range(10):
        jstep(data, target)
        tstep(data, target)
        jlosses.append(jcost.getError())
        tlosses.append(tcost.getError())

    assert np.allclose(tlosses, jlosses, rtol=1e-5, atol=0.0), (tlosses, jlosses)
    assert tlosses[-1] < tlosses[0]

    _close(tnet.graph[0].W, jnet.graph[0].W, 1e-4)


# -- on the card ------------------------------------------------------------------------------

def _needsCard():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the RNN's CUDA path runs only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["uni", "bi"])
@pytest.mark.parametrize("mode", MODES)
def testRnnOnCardMatchesCpu(mode, direction, monkeypatch):
    """Each mode on the card (TF32 off) against the same module, built from
    the same seed, on the CPU: output, input gradient and weight gradient
    within 1e-5."""
    _needsCard()
    x = np.random.RandomState(1).randn(20, 4, 8).astype(np.float32)
    grad = np.random.RandomState(2).randn(20, 4, 16 * (2 if direction == "bi" else 1)).astype(np.float32)

    results = []
    for device in ("cpu", "cuda"):
        monkeypatch.setattr(TConfig, "device", device)
        np.random.seed(13)
        mod = TRNN(8, 16, layers=2, mode=mode, direction=direction, getSequences=True)
        out = mod(torch.from_numpy(x).to(device))
        mod.backward(torch.from_numpy(grad).to(device))
        results.append([out, mod.grad, mod.vars["W"].grad])

    for got, want in zip(results[1], results[0]):
        assert got.is_cuda
        _close(got, want)


@pytest.mark.cuda
def testFusedRnnStepOnCardReplays(monkeypatch):
    """A fused LSTM + Linear step with ``MSE`` on the card: one recording,
    replayed; two runs from the same start give the same bits, and the
    losses follow the eager step's on the CPU within 1e-4."""
    _needsCard()

    def run(device):
        monkeypatch.setattr(TConfig, "device", device)
        np.random.seed(20)
        net = TSequential()
        net.append(TRNN(6, 8, mode="lstm"))
        net.append(TLinear(8, 4))
        opt = TAdam(alpha=0.01)
        opt.setupOn(net, useGlobalState=True)
        cost = TMSE()
        step = TFusedStep(net, cost, opt)

        data = np.random.RandomState(3).randn(5, 3, 6).astype(np.float32)
        target = np.random.RandomState(4).randn(3, 4).astype(np.float32)
        losses = []
        for _ in range(6):
            step(data, target)
            losses.append(cost.getError())

        return losses, step.captures, net.graph[0].W.detach().cpu().clone()

    cpu, _, cpuW = run("cpu")
    first, captures, firstW = run("cuda")
    second, _, secondW = run("cuda")

    assert captures == 1
    assert first == second and torch.equal(firstW, secondW)
    assert np.allclose(first, cpu, rtol=1e-4, atol=0.0)
    _close(firstW, cpuW, 1e-4)
