"""The training slice as a whole: a VGG-shaped net trained by both packages'
``Trainer.trainFromHost`` with ``CrossEntropy`` and ``MomentumSGD`` in global
state, the views of the optimizer's flat buffers, and the container's
backward protocol."""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import containers as TC
from puzzlelib_tpu_torch import handlers as TH
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.convert import paramsFromNumpy, paramsToNumpy, optimizerStateFromNumpy
from puzzlelib_tpu_torch.cost import CrossEntropy as TCrossEntropy
from puzzlelib_tpu_torch.optimizers import MomentumSGD as TMomentumSGD

from test_torch_slice import _narrowVGG


def _jax():
    """The JAX package's modules, containers, handlers, cost and optimizers,
    for the twin tests; they skip where it does not import."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    from puzzlelib_tpu import containers, cost, handlers, modules, optimizers

    return modules, containers, handlers, cost, optimizers


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card, for every test
    of this file (the card-only ones set "cuda" themselves)."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _trainingNet(M, C, initscheme):
    net = _narrowVGG(M, C, initscheme)
    net.pop()   # CrossEntropy takes the raw scores
    return net


def _data(seed, n):
    rng = np.random.RandomState(seed)
    return rng.randn(n, 3, 16, 16).astype(np.float32), rng.randint(0, 10, size=n).astype(np.int32)


def _train(H, net, cost, opt, x, y, seed):
    """One shuffled ``trainFromHost`` under numpy seed ``seed``: the per-step
    errors."""
    errors = []
    trainer = H.Trainer(net, cost, opt, batchsize=4, onBatchFinish=lambda h: errors.append(h.cost.getError()))

    np.random.seed(seed)
    trainer.trainFromHost(x, y, macroBatchSize=len(x))
    return errors


def _assertSameWeights(jnet, tnet, bound):
    got = paramsToNumpy(tnet)
    for var, names in jnet.getVarTable().items():
        want = var.data.get()
        assert np.abs(got[names[0]] - want).max() <= bound * np.abs(want).max(), names[0]


def testNarrowVGGTrainerTwin(onCpu):
    """3 shuffled steps of 4 by both Trainers under one numpy seed, from the
    same weights: the same per-step errors and final weights within 1e-4 of
    max|ref| (the whole-net tolerance of the serving twin).  Then both go on
    for 2 more steps from the JAX package's mid-training state (weights and
    momentum) carried into a fresh port net by the conversion tables."""
    J, JC, JH, JCost, JOpt = _jax()
    np.random.seed(0)
    jnet = _trainingNet(J, JC, "he")

    tnet = _trainingNet(T, TC, "none")
    paramsFromNumpy(tnet, {n: var.data.get() for var, names in jnet.getVarTable().items() for n in names})

    jopt, topt = JOpt.MomentumSGD(0.05, momRate=0.9), TMomentumSGD(0.05, momRate=0.9)
    jopt.setupOn(jnet, useGlobalState=True)
    topt.setupOn(tnet, useGlobalState=True)

    x, y = _data(1, 12)
    want = _train(JH, jnet, JCost.CrossEntropy(), jopt, x, y, seed=5)
    got = _train(TH, tnet, TCrossEntropy(), topt, x, y, seed=5)

    assert len(got) == len(want) == 3
    assert np.abs(np.array(got) - np.array(want)).max() <= 1e-4 * np.abs(want).max()
    _assertSameWeights(jnet, tnet, 1e-4)

    # a fresh port net and optimizer from the JAX package's state
    fresh = _trainingNet(T, TC, "none")
    freshOpt = TMomentumSGD(0.05, momRate=0.9)
    freshOpt.setupOn(fresh, useGlobalState=True)
    paramsFromNumpy(fresh, {n: var.data.get() for var, names in jnet.getVarTable().items() for n in names})
    optimizerStateFromNumpy(freshOpt, {"%s.%s" % (key, entity): tensor.get()
                                       for key, state in jopt.states.items() for entity, tensor in state.items()})

    x, y = _data(2, 8)
    want = _train(JH, jnet, JCost.CrossEntropy(), jopt, x, y, seed=6)
    got = _train(TH, fresh, TCrossEntropy(), freshOpt, x, y, seed=6)

    assert np.abs(np.array(got) - np.array(want)).max() <= 1e-4 * np.abs(want).max()
    _assertSameWeights(jnet, fresh, 1e-4)


def testTrainerStepKeepsVariablesViewsOfThePacks(onCpu):
    """After ``setupOn(useGlobalState=True)`` and one Trainer step every
    ``var.data`` and ``var.grad`` still shares storage with its pack, the
    parameter pack changed, and every variable with it."""
    np.random.seed(3)
    net = _trainingNet(T, TC, "he")
    opt = TMomentumSGD(0.05, momRate=0.9)
    opt.setupOn(net, useGlobalState=True)

    pack, gradPack = opt.shParams[torch.float32].ary, opt.shGrads[torch.float32].ary
    before = pack.clone()
    variables = list(net.getVarTable())
    snapshot = [var.data.clone() for var in variables]

    x, y = _data(4, 4)
    TH.Trainer(net, TCrossEntropy(), opt, batchsize=4).trainFromHost(x, y)

    assert opt.t == 1 and not torch.equal(pack, before)
    for var, old in zip(variables, snapshot):
        assert var.data.untyped_storage().data_ptr() == pack.untyped_storage().data_ptr()
        assert var.grad.untyped_storage().data_ptr() == gradPack.untyped_storage().data_ptr()
        assert not torch.equal(var.data, old)

    # the registered parameters are the same views
    assert all(p.untyped_storage().data_ptr() == pack.untyped_storage().data_ptr() for p in net.parameters())


def testTrainerShufflesAsTheReference(onCpu):
    """Mini-batches in ``np.random.permutation`` order with ``random`` (the
    default), in order without it; labels stay int32."""
    seen = []

    class Probe(TH.Trainer):
        def handleBatch(self, batch, idx, state):
            seen.append((idx, batch[1].dtype))

    net = T.Linear(3, 2, initscheme="he")
    x, y = np.zeros((10, 3), np.float32), np.zeros(10, np.int32)

    np.random.seed(7)
    Probe(net, TCrossEntropy(), None, batchsize=2).trainFromHost(x, y, macroBatchSize=10)
    np.random.seed(7)
    assert [idx for idx, _ in seen] == list(np.random.permutation(5)) and seen[0][1] == torch.int32

    seen.clear()
    Probe(net, TCrossEntropy(), None, batchsize=2).trainFromHost(x, y, macroBatchSize=10, random=False)
    assert [idx for idx, _ in seen] == list(range(5))


def testSequentialBackwardOrderAndHead(onCpu):
    """Backward walks the modules in reverse; only the head honours
    ``updGrad``; the default momentum 1.0 adds onto the buffers."""
    np.random.seed(8)
    net = _trainingNet(T, TC, "he")
    x = torch.from_numpy(_data(9, 2)[0])

    out = net(x)
    net.backward(torch.ones_like(out), updGrad=False)
    assert net.grad is None and net[0].grad is None and net[1].grad is not None

    first = net["fc"].vars["W"].grad.clone()
    net(x)
    net.backward(torch.ones_like(out), updGrad=True)
    assert tuple(net.grad.shape) == tuple(x.shape)
    assert torch.allclose(net["fc"].vars["W"].grad, 2 * first)

    net.zeroGradParams()
    assert all((var.grad == 0).all() for var in net.getVarTable())


def testSequentialPopAndInplaceCheck(onCpu):
    net = TC.Sequential()
    net.append(T.Linear(4, 3, initscheme="he", name="fc"))
    net.append(T.Activation(T.relu, name="relu"))
    net.append(T.Flatten(name="flat"))

    # relu's backward re-reads its output, also through a data mover
    with pytest.raises(TC.ContainerError):
        net.append(T.Activation(T.relu, inplace=True, name="inplace"))

    assert net.pop().name == "flat" and [m.name for m in net.graph] == ["fc", "relu"]
    assert net.gradUsesOutData and not net.inplace

    with pytest.raises(TC.ContainerError):
        net.append(T.Activation(T.relu, inplace=True, name="inplace"))


@pytest.mark.cuda
def testTrainingStepOnCardThroughKernels(monkeypatch):
    """A narrow net whose 3x3 convs the Winograd kernels take (C = CO = 128),
    trained 2 steps in bf16 on the card: K2 runs forward and bwd-data, K3
    the bwd-filter, K1 the fc forward; the losses are finite and agree with
    the same steps on the library route at the bf16 tier."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ built with nvcc")

    from puzzlelib_tpu_torch.ops.hopper import matmul, winograd

    monkeypatch.setattr(TConfig, "device", "cuda")
    monkeypatch.setattr(TConfig, "convAlgo", "hopper")
    monkeypatch.setattr(TConfig, "gemmAlgo", "hopper")

    def build():
        np.random.seed(4)
        net = TC.Sequential()
        net.append(T.Conv2D(3, 128, 3, pad=1, initscheme="he", name="c1"))
        net.append(T.Activation(T.relu, name="r1"))
        net.append(T.Conv2D(128, 128, 3, pad=1, initscheme="he", name="c2"))
        net.append(T.Activation(T.relu, name="r2"))
        net.append(T.MaxPool2D(name="p"))
        net.append(T.Flatten())
        net.append(T.Linear(128 * 4 * 4, 16, initscheme="he", name="fc"))
        net.calcMode(torch.bfloat16)

        opt = TMomentumSGD(1e-3, momRate=0.9)
        opt.setupOn(net, useGlobalState=True)
        return net, opt

    x = np.random.RandomState(5).randn(8, 3, 8, 8).astype(np.float32)
    y = np.random.RandomState(6).randint(0, 16, size=8).astype(np.int32)

    losses = {}
    for algo in ("hopper", "torch"):
        monkeypatch.setattr(TConfig, "convAlgo", algo)
        monkeypatch.setattr(TConfig, "gemmAlgo", algo)
        net, opt = build()

        before = (winograd.launches, winograd.dataGradLaunches, winograd.filterGradLaunches, matmul.launches)
        losses[algo] = _train(TH, net, TCrossEntropy(), opt, x, y, seed=7)
        torch.cuda.synchronize()
        counts = (winograd.launches - before[0], winograd.dataGradLaunches - before[1],
                  winograd.filterGradLaunches - before[2], matmul.launches - before[3])

        # c2 forward and bwd-data (c1's input has 3 channels), c2 bwd-filter, fc forward: per step
        assert counts == ((4, 2, 2, 2) if algo == "hopper" else (0, 0, 0, 0))

    assert np.isfinite(losses["hopper"]).all()
    assert np.abs(np.array(losses["hopper"]) - np.array(losses["torch"])).max() <= 5e-2 * max(losses["torch"])
