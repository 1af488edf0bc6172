"""The U-Net slice against the JAX package: ``loadUNet`` at full width on
(2, 1, 32, 32), the size of the JAX package's ``testUNetNumericOracle``:
its structure, the forward with dropout in eval mode and the backward,
three ``MomentumSGD`` steps with ``BCE`` with dropout on injected draws, one
``FusedStep`` against the eager step, and ``tools/unetslice.py``.

Each twin builds the JAX net and the port's from one numpy seed; the draws
of the dropouts are injected into both packages' modules (``_drawRands``),
as the CNN twins inject them.  f32 is held within 1e-5 of max(1, max
|want|).  The card-only case (``cuda`` marker) runs the U-Net forward
through K2 against the library route."""

import functools

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import fused
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.convert import paramsFromNumpy, paramsToNumpy
from puzzlelib_tpu_torch.cost import BCE as TBCE
from puzzlelib_tpu_torch.handlers import Trainer
from puzzlelib_tpu_torch.models import nets as TNets
from puzzlelib_tpu_torch.optimizers import MomentumSGD as TMomentumSGD
from puzzlelib_tpu_torch.rng import globalRng
from puzzlelib_tpu_torch.tools import resnetslice, unetslice


F32_BOUND = 1e-5
SHAPE = (2, 1, 32, 32)
BATCH, STEPS, LEARN_RATE, MOM_RATE = 2, 3, 1e-3, 0.99


def _jax():
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    from puzzlelib_tpu import cost, handlers, modules, optimizers
    from puzzlelib_tpu.backend import gpuarray
    from puzzlelib_tpu.models.nets import loadUNet

    return loadUNet, modules, cost, optimizers, handlers, gpuarray


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card (the card-only
    case sets "cuda" itself)."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()

    return np.asarray(value.get() if hasattr(value, "get") else value, dtype=np.float32)


def _close(got, want, bound=F32_BOUND):
    got, want = _host(got), _host(want)
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def _jvars(jnet):
    return {name: np.asarray(var.data.get(), np.float32) for var, names in jnet.getVarTable().items()
            for name in names}


class _Draws:
    """Seeded uint32 draws per module name, in the order a module asks for
    them; one feed for each package, from the same seeds."""

    def __init__(self, seed):
        self.seed, self.calls = seed, {}

    def inject(self, mod, asTensor):
        def draw(size):
            call = self.calls[mod.name] = self.calls.get(mod.name, 0) + 1
            rng = np.random.RandomState([self.seed, call, sum(map(ord, mod.name))])
            return asTensor(rng.randint(0, 2 ** 32, size=size, dtype=np.uint64).astype(np.uint32))

        mod._drawRands = draw


@functools.lru_cache(maxsize=None)
def _table():
    """The JAX package's U-Net weights from ``np.random.seed(10)`` and the
    He scheme, by variable name, drawn once for the file's twins."""
    jLoadUNet = _jax()[0]
    np.random.seed(10)
    return _jvars(jLoadUNet(None, initscheme="he"))


def _twins():
    """(JAX net, port net), both holding ``_table()``'s weights."""
    jLoadUNet = _jax()[0]
    jnet, tnet = jLoadUNet(None, initscheme="none"), TNets.loadUNet(None, initscheme="none")

    for var, names in jnet.getVarTable().items():
        var.data.set(_table()[names[0]])
    paramsFromNumpy(tnet, _table())
    return jnet, tnet


def testUNetStructureTwin(monkeypatch):
    """Same module names and types, variable names and shapes, parameter
    count and ``dataShapeFrom`` chain in both packages, and the 15 convs
    that K2 and K3 take at the slice's 512 x 512 input."""
    jLoadUNet = _jax()[0]
    from puzzlelib_tpu import config as JConfig

    monkeypatch.setattr(JConfig, "globalEvalMode", True)
    monkeypatch.setattr(TConfig, "globalEvalMode", True)
    jnet, tnet = jLoadUNet(None, initscheme="none"), TNets.loadUNet(None, initscheme="none")

    assert tnet.name == jnet.name == "unet"
    assert [(m.name, type(m).__name__) for m in tnet.graph] == [(m.name, type(m).__name__) for m in jnet.graph]
    jvars = {name: tuple(var.data.shape) for var, names in jnet.getVarTable().items() for name in names}
    assert {name: tuple(var.data.shape) for var, names in tnet.getVarTable().items() for name in names} == jvars
    assert tnet.numOfParams() == jnet.numOfParams() == 31804225

    shape = SHAPE
    for jmod, tmod in zip(jnet.graph, tnet.graph):
        assert tmod.dataShapeFrom(shape) == jmod.dataShapeFrom(shape)
        shape = jmod.dataShapeFrom(shape)
    assert tuple(shape) == SHAPE

    assert resnetslice.winogradConvs(tnet, (unetslice.BATCH, ) + unetslice.SHAPE) == (
        ["conv_2_2", "conv_3_1", "conv_3_2", "conv_4_1", "conv_4_2", "conv_5_1", "conv_5_2", "conv_6_1", "conv_6_2",
         "conv_6_3", "conv_7_1", "conv_7_2", "conv_7_3", "conv_8_1", "conv_8_2"])
    assert sum(len(names.split()) for names, _, _ in unetslice.KERNEL_CONVS) == 15


def testLoadUNetRefusesACheckpoint(monkeypatch, tmp_path):
    """The loader's ``modelpath`` loads the file the JAX package's U-Net
    wrote: every variable bit-equal to the JAX net's, so the forward is the
    one ``testUNetForwardBackwardTwin`` holds to the JAX package's."""
    jLoadUNet = _jax()[0]
    from puzzlelib_tpu import config as JConfig

    monkeypatch.setattr(JConfig, "globalEvalMode", True)
    monkeypatch.setattr(TConfig, "globalEvalMode", True)

    _loadsJaxFile(jLoadUNet(None, initscheme="none"), TNets.loadUNet, str(tmp_path / "unet.hdf"), unique=False)


def _loadsJaxFile(jnet, load, path, unique):
    """``load(path)`` (a zoo loader's ``modelpath``) of the file the JAX net
    wrote: every variable of the port's net bit-equal to the JAX net's.
    Returns the port's net."""
    jnet.save(path, compress=None, assumeUniqueNames=unique)
    tnet = load(path)

    want = {name: np.asarray(var.data.get()) for var, names in jnet.getVarTable().items() for name in names}
    got = {name: var.data.detach().numpy() for var, names in tnet.getVarTable().items() for name in names}
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert np.array_equal(got[name].view(np.uint32), value.view(np.uint32)), name

    return tnet




def testUNetForwardBackwardTwin():
    """The forward with the dropouts in eval mode (the sigmoid's output),
    the input gradient and every variable's gradient of one backward; the
    port's He weights from the same numpy seed are the JAX package's, to
    the bit."""
    _, J, _, _, _, jgpu = _jax()
    jnet, tnet = _twins()

    np.random.seed(10)
    drawn = paramsToNumpy(TNets.loadUNet(None, initscheme="he"))
    assert sorted(drawn) == sorted(_table()) and all(np.array_equal(drawn[n], a) for n, a in _table().items())
    for jdrop, tdrop in zip(jnet.getAllByType(J.Dropout), tnet.getAllByType(T.Dropout)):
        jdrop.evalMode()
        tdrop.evalMode()

    x = np.random.RandomState(2).randn(*SHAPE).astype(np.float32)
    grad = np.random.RandomState(3).randn(*SHAPE).astype(np.float32)

    jout = jnet(jgpu.to_gpu(x))
    tout = tnet(torch.from_numpy(x))
    _close(tout, jout)

    jnet.backward(jgpu.to_gpu(grad))
    tnet.backward(torch.from_numpy(grad))
    _close(tnet.grad, jnet.grad)

    jgrads = {name: var.grad for var, names in jnet.getVarTable().items() for name in names}
    tgrads = {name: var.grad for var, names in tnet.getVarTable().items() for name in names}
    assert sorted(tgrads) == sorted(jgrads) and len(tgrads) == 48
    for name, want in jgrads.items():
        _close(tgrads[name], want)


def _trainingTwins():
    """The twins without their sigmoids, each with MomentumSGD in global
    state and injected dropout draws, and the data: (images, masks)."""
    _, J, _, JOpt, _, jgpu = _jax()
    jnet, tnet = _twins()
    jnet.pop()
    tnet.pop()

    jdraws, tdraws = _Draws(11), _Draws(11)
    for jdrop, tdrop in zip(jnet.getAllByType(J.Dropout), tnet.getAllByType(T.Dropout)):
        jdraws.inject(jdrop, jgpu.to_gpu)
        tdraws.inject(tdrop, lambda ary: torch.from_numpy(ary.astype(np.int64)))

    jopt, topt = JOpt.MomentumSGD(LEARN_RATE, momRate=MOM_RATE), TMomentumSGD(LEARN_RATE, momRate=MOM_RATE)
    jopt.setupOn(jnet, useGlobalState=True)
    topt.setupOn(tnet, useGlobalState=True)

    images, masks = unetslice.data(BATCH * STEPS, seed=4, shape=SHAPE[1:])
    return (jnet, jopt), (tnet, topt), images, masks


def _train(trainerCls, net, cost, opt, images, masks):
    losses = []
    np.random.seed(9)
    trainerCls(net, cost, opt, onBatchFinish=lambda h: losses.append(h.cost.getError()),
               batchsize=BATCH).trainFromHost(images, masks)
    return losses


def testUNetMomentumSGDTwin():
    """Three steps of ``MomentumSGD(1e-3, 0.99)`` in global state with
    ``BCE`` through ``Trainer``, the dropouts on the same injected draws:
    the per-step losses and the final weights against the JAX package's."""
    _, _, JCost, _, JHandlers, _ = _jax()
    (jnet, jopt), (tnet, topt), images, masks = _trainingTwins()

    want = _train(JHandlers.Trainer, jnet, JCost.BCE(), jopt, images, masks)
    got = _train(Trainer, tnet, TBCE(), topt, images, masks)

    assert len(got) == STEPS and np.isfinite(got).all()
    _close(np.array(got), np.array(want))
    table = paramsToNumpy(tnet)
    for name, ary in _jvars(jnet).items():
        _close(table[name], ary)


def testUNetFusedStepTwin():
    """One ``FusedStep`` step against one eager ``Trainer`` step from the
    same weights and the same dropout draws (the generator reseeded): the
    same loss and weights."""
    net = TNets.loadUNet(None, initscheme="none")
    paramsFromNumpy(net, _table())
    net.pop()
    opt = TMomentumSGD(LEARN_RATE, momRate=MOM_RATE)
    opt.setupOn(net, useGlobalState=True)
    start = {name: ary.copy() for name, ary in paramsToNumpy(net).items()}
    images, masks = unetslice.data(BATCH, seed=4, shape=SHAPE[1:])

    globalRng.seed(3)
    eager = _train(Trainer, net, TBCE(), opt, images, masks)
    eagerWeights = paramsToNumpy(net)

    paramsFromNumpy(net, start)
    for state in opt.states.values():
        for tensor in state.values():
            tensor.zero_()

    globalRng.seed(3)
    cost = fused.FusedStep(net, TBCE(), opt)(torch.from_numpy(images), torch.from_numpy(masks))
    assert cost.getError() == pytest.approx(eager[0], rel=F32_BOUND)
    weights = paramsToNumpy(net)
    for name, ary in eagerWeights.items():
        _close(weights[name], ary)


def testUNetSliceRunTrainsValidatesAndServes():
    """``unetslice.buildRun`` at the 32 x 32 size: the masks are (N, H, W)
    int32 {0, 1}; a run trains (repeating from its start), validates with
    ``BCE`` and serves the sigmoid's outputs through the Calculator and the
    FusedCalculator."""
    images, masks = unetslice.data(4, shape=SHAPE[1:])
    assert images.shape == (4, ) + SHAPE[1:] and images.dtype == np.float32
    assert masks.shape == (4, 32, 32) and masks.dtype == np.int32 and set(np.unique(masks)) == {0, 1}

    net = TNets.loadUNet(None, initscheme="none")
    paramsFromNumpy(net, _table())
    run = unetslice.buildRun(net, dtype=torch.float32, batch=2)
    assert not any(isinstance(mod, T.Activation) and mod.activation == T.sigmoid for mod in run.net.graph)

    losses, again = [], []
    run.train("hopper", images, masks, losses)
    run.train("hopper", images, masks, again)
    assert len(losses) == 2 and losses == again

    error, _ = run.validate("hopper", images, masks)
    assert 0.0 <= error <= 1.0

    out, _ = run.serve("hopper", images)
    fusedOut, _ = run.serve("fused", images)
    assert out.shape == (4, ) + SHAPE[1:] and ((out > 0) & (out < 1)).all()
    np.testing.assert_allclose(fusedOut, out, rtol=F32_BOUND, atol=F32_BOUND)


@pytest.mark.cuda
def testUNetForwardThroughK2OnCard(monkeypatch):
    """U-Net in bf16 on a 1 x 64 x 64 input through ``Calculator`` on the
    hand kernels: 15 K2 launches, within 5e-2 relative L2 of the library
    route's sigmoid outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from puzzlelib_tpu_torch.handlers import Calculator
    from puzzlelib_tpu_torch.ops.hopper import winograd

    monkeypatch.setattr(TConfig, "device", "cuda")
    monkeypatch.setattr(TConfig, "globalEvalMode", True)
    np.random.seed(0)
    net = TNets.loadUNet(None, initscheme="he")
    net.calcMode(torch.bfloat16)
    images = np.random.RandomState(1).randn(2, 1, 64, 64).astype(np.float32)
    convs = resnetslice.winogradConvs(net, (2, 1, 64, 64))

    outs = {}
    for algo in ("torch", "hopper"):
        monkeypatch.setattr(TConfig, "convAlgo", algo)
        before = winograd.launches
        outs[algo] = Calculator(net, batchsize=2).calcFromHost(images)
        outs[algo + " launches"] = winograd.launches - before

    assert len(convs) == 15 and outs["hopper launches"] == 15 and outs["torch launches"] == 0
    assert np.linalg.norm(outs["hopper"] - outs["torch"]) / np.linalg.norm(outs["torch"]) <= 5e-2
