"""``puzzlelib_tpu_torch/testlib/gradientcheck.py`` against the root
script: its conv / batch-norm net built in both packages from one numpy
seed (the same weights, checked), then ``gradientCheck``'s central
differences over every parameter.

A relative error r = |(L(w + h) - L(w - h)) / 2h - a| / |a + h| takes the
losses' last bits times 1 / (2h |a + h|), up to 5e5 at h = 1e-3: the f32
losses of two implementations, an ulp or two apart, give relative errors
up to ~1e-3 apart.  So the twin holds what r is computed from: every loss
that ``gradientCheck`` evaluates and every analytic gradient within the
f32 tier (1e-5 of max(1, |ref|)) of the JAX package's, and each package's
relative errors equal to r recomputed from its own losses and gradients;
then the median gate of ``tests/test_gradientcheck.py`` (below 1e-2) in
both."""

import importlib

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch.convert import paramsToNumpy
from puzzlelib_tpu_torch.cost import BCE as TBCE
from puzzlelib_tpu_torch.testlib import gradientcheck as TGrad


BOUND = 1e-5


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    monkeypatch.setattr(TConfig, "device", "cpu")


def _jax():
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    from puzzlelib_tpu.backend import gpuarray
    from puzzlelib_tpu.cost import BCE

    return importlib.import_module("testlib.gradientcheck"), gpuarray, BCE


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return rng.randn(1, 1, 6, 6).astype(np.float32), rng.randint(0, 2, size=(1, )).astype(np.int32)


class _Recorded:
    """A cost that records the loss of each call."""

    def __init__(self, cost):
        self.cost, self.losses = cost, []

    def __call__(self, pred, target):
        loss, grad = self.cost(pred, target)
        self.losses.append(float(loss))
        return loss, grad


def _relErrors(losses, grads, h=1e-3):
    """r of each parameter entry, recomputed from the losses of its two
    perturbations (after the first, unperturbed call) and its gradient."""
    plus, minus = np.asarray(losses[1::2]), np.asarray(losses[2::2])
    analytic = -np.concatenate([g.ravel() for g in grads]).astype(np.float64)
    return np.abs(((plus - minus) / (2.0 * h) - analytic) / (analytic + h))


@pytest.mark.parametrize("seed", [0, 1, 2])
def testGradientCheckTwin(seed):
    """``buildNet`` from ``np.random.seed(seed)`` in both packages, then
    ``gradientCheck`` (h = 1e-3) on one seeded 6 x 6 image: 33 relative
    errors from 67 losses, the losses and the analytic gradients within the
    f32 tier of the JAX package's, each package's relative errors those of
    its own losses and gradients, the median below 1e-2 in both."""
    JGrad, jgpu, JBCE = _jax()
    x, y = _inputs(seed + 10)

    np.random.seed(seed)
    jnet = JGrad.buildNet()
    np.random.seed(seed)
    tnet = TGrad.buildNet()

    table = {name: var.data.get() for var, names in jnet.getVarTable().items() for name in names}
    tables = paramsToNumpy(tnet)
    assert sorted(tables) == sorted(table)
    assert all(np.array_equal(ary, table[name]) for name, ary in tables.items())

    jcost, tcost = _Recorded(JBCE()), _Recorded(TBCE())
    want = JGrad.gradientCheck(jnet, jgpu.to_gpu(x), jgpu.to_gpu(y), jcost, log=False)
    got = TGrad.gradientCheck(tnet, torch.from_numpy(x), torch.from_numpy(y), tcost, log=False)
    jgrads = [np.asarray(var.grad.get()) for var in jnet.getVarTable()]
    tgrads = [var.grad.numpy() for var in tnet.getVarTable()]

    assert len(got) == len(want) == 33 and len(tcost.losses) == len(jcost.losses) == 67
    assert np.abs(np.subtract(tcost.losses, jcost.losses)).max() <= BOUND * max(1.0, np.abs(jcost.losses).max())
    for tgrad, jgrad in zip(tgrads, jgrads):
        assert np.abs(tgrad - jgrad).max() <= BOUND * max(1.0, np.abs(jgrad).max())

    for errors, cost, grads in ((got, tcost, tgrads), (want, jcost, jgrads)):
        assert np.allclose(errors, _relErrors(cost.losses, grads), rtol=1e-6, atol=0.0)
        assert np.median(errors) < 1e-2


def testGradientCheckKeepsTheWeights():
    """Every parameter is put back after its perturbations: the weights
    after ``gradientCheck`` are the ones before it, bit for bit."""
    x, y = _inputs(3)
    np.random.seed(4)
    net = TGrad.buildNet()
    before = paramsToNumpy(net)

    TGrad.gradientCheck(net, torch.from_numpy(x), torch.from_numpy(y), TBCE(), log=False)
    after = paramsToNumpy(net)
    assert all(np.array_equal(after[name], ary) for name, ary in before.items())


def testMainPrintsItsErrors(capsys):
    """``main`` of both packages under one numpy seed: 33 printed relative
    errors each, the same as the returned ones, median below 1e-2."""
    JGrad, _, _ = _jax()
    for script in (JGrad, TGrad):
        np.random.seed(5)
        returned = script.main()
        printed = [float(line) for line in capsys.readouterr().out.split()]

        if returned is not None:
            assert np.allclose(printed, returned, rtol=1e-6, atol=0.0)
        assert len(printed) == 33 and np.median(printed) < 1e-2
