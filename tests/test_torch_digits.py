"""The port's ``digitslenet``, ``digitsreal`` and ``digitsnin``
(``puzzlelib_tpu_torch/testlib``) against the root scripts.

The loaders read scikit-learn's bundled digits; the port's must give the
root scripts' arrays bit for bit, on the real digits and on the seeded
arrays of ``tools/dataslice.digits`` (scikit-learn's ``load_digits``
replaced), which the card trains on.  Then each script's net is built in
both packages from the script's numpy seed (the same weights, checked),
runs one forward, and takes two steps of its recipe: outputs, losses and
weights within 1e-5 of max(1, max |ref|), the f32 tier.  The tied
autoencoder's ``W`` (one variable in two modules) is stepped once a step
in both packages.  The NIN's dropouts take the same injected draws in both
(``_FixedDraws``: the JAX package's fused step draws once, as it traces)."""

import importlib

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch.convert import paramsToNumpy
from puzzlelib_tpu_torch.testlib import digitslenet as TLenet
from puzzlelib_tpu_torch.testlib import digitsnin as TNin
from puzzlelib_tpu_torch.testlib import digitsreal as TReal
from puzzlelib_tpu_torch.tools import dataslice as Data


BOUND = 1e-5


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    monkeypatch.setattr(TConfig, "device", "cpu")


def _jax(script):
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    return importlib.import_module("testlib." + script)


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy().copy()

    return np.asarray(value.get() if hasattr(value, "get") else value, dtype=np.float32)


def _close(got, want, bound=BOUND):
    got, want = _host(got), _host(want)
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def _table(jnet):
    return {name: np.asarray(var.data.get()) for var, names in jnet.getVarTable().items() for name in names}


def _sameStart(jnet, tnet):
    table, tables = _table(jnet), paramsToNumpy(tnet)
    assert sorted(tables) == sorted(table)
    assert all(np.array_equal(ary, table[name]) for name, ary in tables.items())


def _sameWeights(jnet, tnet):
    table, tables = _table(jnet), paramsToNumpy(tnet)
    assert sorted(tables) == sorted(table)
    for name, ary in tables.items():
        _close(ary, table[name])


# -- the loaders ---------------------------------------------------------------------------------------

LOADERS = {"digitslenet": ("loadDigits", TLenet.loadDigits), "digitsreal": ("loadDigits", TReal.loadDigits),
           "digitsnin": ("loadDigits32", TNin.loadDigits32)}


@pytest.mark.parametrize("script", sorted(LOADERS))
def testLoaderBitEqual(script):
    """The real digits through the root script's loader and the port's."""
    pytest.importorskip("sklearn", reason="the loaders read scikit-learn's bundled digits")
    name, portLoader = LOADERS[script]
    want, got = getattr(_jax(script), name)(), portLoader()

    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


@pytest.mark.parametrize("script", sorted(LOADERS))
def testLoaderOnSeededDigitsBitEqual(script, monkeypatch):
    """The seeded arrays of ``dataslice.digits`` (1797 images of 8 x 8 in [0,
    16]) through the root script's loader, its ``load_digits`` replaced, and
    through the port's prepare step: the same arrays, bit for bit."""
    pytest.importorskip("sklearn", reason="the root scripts' loaders import scikit-learn")
    import sklearn.datasets
    from sklearn.utils import Bunch

    images, target = Data.digits()
    assert images.shape == (1797, 8, 8) and images.min() == 0 and images.max() == 16
    monkeypatch.setattr(sklearn.datasets, "load_digits", lambda: Bunch(images=images, target=target))

    prepare = {"digitslenet": TLenet.prepareDigits, "digitsreal": TReal.prepareDigits,
               "digitsnin": TNin.prepareDigits32}[script]
    want, got = getattr(_jax(script), LOADERS[script][0])(), prepare(images, target)

    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


def _digits(count, seed=3):
    images, target = Data.digits(count=count, seed=seed)
    return images, target


# -- digitslenet -----------------------------------------------------------------------------------

def testLeNetRecipeTwin():
    """``buildLeNet`` from the script's seed, one forward of 4 images, two
    ``FusedTrainer`` steps of 100 under ``MomentumSGD(0.01, 0.9)`` in global
    state, then the ``Validator``'s error of 99 images."""
    J = _jax("digitslenet")
    from puzzlelib_tpu import cost as JCost, fused as JFused, handlers as JH, optimizers as JOpt
    from puzzlelib_tpu.backend import gpuarray as jgpu

    trainX, trainY, valX, valY = TLenet.prepareDigits(*_digits(1600))

    np.random.seed(0)
    jnet = J.buildLeNet()
    jopt = JOpt.MomentumSGD(learnRate=0.01, momRate=0.9)
    jopt.setupOn(jnet, useGlobalState=True)
    jcost = JCost.CrossEntropy(maxlabels=10)
    jtrainer, jval = JFused.FusedTrainer(jnet, jcost, jopt, batchsize=100), JH.Validator(jnet, jcost, batchsize=99)

    tnet, ttrainer, tval, _ = TLenet.buildTraining()
    _sameStart(jnet, tnet)
    _close(tnet(torch.from_numpy(trainX[:4])), jnet(jgpu.to_gpu(trainX[:4])))

    losses = {}
    for name, trainer in (("jax", jtrainer), ("port", ttrainer)):
        losses[name] = []
        trainer.onBatchFinish = lambda h, out=losses[name]: out.append(h.cost.getError())
        np.random.seed(5)
        trainer.trainFromHost(trainX[:200], trainY[:200], macroBatchSize=200, onMacroBatchFinish=lambda t: None)

    assert len(losses["port"]) == 2
    _close(losses["port"], losses["jax"])
    _sameWeights(jnet, tnet)
    _close(tval.validateFromHost(valX[:99], valY[:99]), jval.validateFromHost(valX[:99], valY[:99]))


# -- digitsreal ------------------------------------------------------------------------------------

def _jaxAutoencoder():
    """The root script's tied autoencoder and optimizer from
    ``np.random.seed(0)``, as ``runAutoencoder`` builds them."""
    _jax("digitsreal")
    from puzzlelib_tpu.backend import gpuarray
    from puzzlelib_tpu.containers import Sequential
    from puzzlelib_tpu.modules import Activation, Linear, sigmoid
    from puzzlelib_tpu.optimizers import MomentumSGD
    from puzzlelib_tpu.variable import Variable

    np.random.seed(0)
    net = Sequential()
    net.append(Linear(64, 32))
    net.append(Activation(sigmoid))

    decoder = Linear(32, 64, empty=True, transpose=True)
    decoder.setVar("W", net[0].vars["W"])
    decoder.setVar("b", Variable(gpuarray.zeros((64, ), dtype=np.float32)))
    net.append(decoder)

    optimizer = MomentumSGD(learnRate=2.0, momRate=0.9)
    optimizer.setupOn(net, useGlobalState=True)
    return net, optimizer


def _aeStep(net, optimizer, mse, batch, upload):
    """One step of ``runAutoencoder``'s loop: (output, loss, W before, W's
    gradient, W after)."""
    x = upload(batch)
    out = net(x)
    loss, grad = mse(out, x)
    before = _host(net[0].vars["W"].data)
    net.zeroGradParams()
    net.backward(grad)
    stepGrad = _host(net[0].vars["W"].grad)
    optimizer.update()
    net.reset()
    return _host(out), loss, before, stepGrad, _host(net[0].vars["W"].data)


def testAutoencoderRecipeTwin():
    """The tied autoencoder from the script's seed: ``W`` under two names,
    one block of the flat buffer (both modules' views, and their gradients,
    at one address); two steps of 100 with ``MSE``:
    outputs, losses and weights.  The first step moves ``W`` by exactly
    the rate times its gradient in both packages (stepped once, not once a
    module), the second by the momentum step."""
    from puzzlelib_tpu.backend import gpuarray as jgpu
    from puzzlelib_tpu.cost import MSE as JMSE
    from puzzlelib_tpu_torch.cost import MSE as TMSE

    jnet, jopt = _jaxAutoencoder()
    tnet, topt = TReal.buildAutoencoder()
    _sameStart(jnet, tnet)

    encoder, decoder = tnet[0].vars["W"], tnet[2].vars["W"]
    assert encoder.data.data_ptr() == decoder.data.data_ptr() and encoder.grad.data_ptr() == decoder.grad.data_ptr()
    assert sum(sh.ary.numel() for sh in topt.shParams.values()) == 64 * 32 + 32 + 64

    images, _ = TReal.prepareDigits(*_digits(200))
    data = images.reshape(-1, 64)

    jmse, tmse = JMSE(), TMSE()
    momentum = {}
    for i in range(2):
        batch = data[i * 100:(i + 1) * 100]
        jout, jloss, jbefore, jgrad, jafter = _aeStep(jnet, jopt, jmse, batch, jgpu.to_gpu)
        tout, tloss, tbefore, tgrad, tafter = _aeStep(tnet, topt, tmse, batch, torch.from_numpy)

        _close(tout, jout)
        _close(tloss, jloss)
        _close(tgrad, jgrad)
        _close(tafter, jafter)

        for name, before, grad, after in (("jax", jbefore, jgrad, jafter), ("port", tbefore, tgrad, tafter)):
            momentum[name] = 0.9 * momentum.get(name, 0.0) + 2.0 * grad
            _close(after - before, momentum[name])

    _sameWeights(jnet, tnet)


def testLstmRecipeTwin():
    """The LSTM classifier from the script's seed, one forward of 4
    sequences of 8 rows, two ``FusedTrainer`` steps of 100 under
    ``Adam(3e-3)`` in global state, then the ``Validator``'s error."""
    _jax("digitsreal")
    from puzzlelib_tpu import cost as JCost, fused as JFused, handlers as JH, optimizers as JOpt
    from puzzlelib_tpu.backend import gpuarray as jgpu
    from puzzlelib_tpu.containers import Sequential
    from puzzlelib_tpu.modules import RNN, Linear, SwapAxes

    np.random.seed(1)
    jnet = Sequential()
    jnet.append(SwapAxes(0, 1))
    jnet.append(RNN(8, 64, mode="lstm", getSequences=False))
    jnet.append(Linear(64, 10))
    jopt = JOpt.Adam(alpha=3e-3)
    jopt.setupOn(jnet, useGlobalState=True)
    jcost = JCost.CrossEntropy(maxlabels=10)
    jtrainer, jval = JFused.FusedTrainer(jnet, jcost, jopt, batchsize=100), JH.Validator(jnet, jcost, batchsize=99)

    tnet, ttrainer, tval, _ = TReal.buildLstm()
    _sameStart(jnet, tnet)

    images, labels = TReal.prepareDigits(*_digits(300))
    _close(tnet(torch.from_numpy(images[:4])), jnet(jgpu.to_gpu(images[:4])))

    losses = {}
    for name, trainer in (("jax", jtrainer), ("port", ttrainer)):
        losses[name] = []
        trainer.onBatchFinish = lambda h, out=losses[name]: out.append(h.cost.getError())
        np.random.seed(6)
        trainer.trainFromHost(images[:200], labels[:200], macroBatchSize=200)

    assert len(losses["port"]) == 2
    _close(losses["port"], losses["jax"])
    _sameWeights(jnet, tnet)
    _close(tval.validateFromHost(images[200:299], labels[200:299]),
           jval.validateFromHost(images[200:299], labels[200:299]))


# -- digitsnin -------------------------------------------------------------------------------------

def testNinRecipeTwin():
    """The CIFAR-10 NIN from the script's seed, its recipe (``MomentumSGD``
    in local state with ``GradClip(1.0)`` then ``WeightDecay(1e-4)``, the
    warm-up rate of epoch 1) through ``FusedTrainer`` at 2 steps a dispatch
    on two batches of 8 shifted, standardized digits, then the
    ``FusedValidator``'s error of 8 images: the mean loss, the weights and
    the error."""
    J = _jax("digitsnin")
    from puzzlelib_tpu import cost as JCost, fused as JFused, optimizers as JOpt
    from puzzlelib_tpu.backend import gpuarray as jgpu
    from puzzlelib_tpu.optimizers import hooks as JHooks

    from test_torch_fused import _FixedDraws

    data, labels = TNin.prepareDigits32(*_digits(24))
    data = TNin.standardize(data)
    shifted = Data.augmentShift(data[:16], np.random.RandomState(TNin.SHIFT_SEED))
    assert np.array_equal(shifted, J.augmentShift(data[:16], np.random.RandomState(TNin.SHIFT_SEED)))

    np.random.seed(TNin.SEED)
    jnet = J.buildNet()
    jopt = JOpt.MomentumSGD(learnRate=0.1, momRate=0.9)
    jopt.addHook(JHooks.GradClip(1.0))
    jopt.addHook(JHooks.WeightDecay(0.0001))
    jopt.setupOn(jnet, useGlobalState=False)
    jcost = JCost.CrossEntropy(maxlabels=10)
    jtrainer = JFused.FusedTrainer(jnet, jcost, jopt, batchsize=8, stepsPerDispatch=2)
    jval = JFused.FusedValidator(jnet, jcost, batchsize=8)

    tnet, topt, ttrainer, tval = TNin.buildTraining(stepsPerDispatch=2)
    ttrainer.batchsize = tval.batchsize = 8
    _sameStart(jnet, tnet)

    for name in ("drop3", "drop6"):
        _FixedDraws(11).inject(jnet[name], name, jgpu.to_gpu)
        _FixedDraws(11).inject(tnet[name], name, lambda ary: torch.from_numpy(ary.astype(np.int64)))

    errors = {}
    for name, opt, trainer in (("jax", jopt, jtrainer), ("port", topt, ttrainer)):
        opt.learnRate = TNin.learnRate(1)
        np.random.seed(8)
        trainer.trainFromHost(shifted, labels[:16], macroBatchSize=16)
        errors[name] = trainer.cost.getMeanError()

    assert TNin.learnRate(1) == 0.1 / 30 and TNin.learnRate(260) == pytest.approx(0.1 * 0.1 * 0.1)
    _close(errors["port"], errors["jax"])
    _sameWeights(jnet, tnet)
    _close(tval.validateFromHost(data[16:], labels[16:]), jval.validateFromHost(data[16:], labels[16:]))
