"""The port's counterparts of the JAX package's ``testlib`` training
scripts (``puzzlelib_tpu_torch/testlib``) against the root scripts.

Each net at its script's full width is built in both packages from one
numpy seed (the same weights, checked), runs one forward on 4 rows, then
two steps of 4 of its script's recipe (``MomentumSGD`` in global state,
with ``WeightDecay(1e-4)`` for the NIN; ``Adam(1e-3)`` and ``BCE`` for the
IMDB nets) through ``Trainer``: outputs, step losses and weights within
1e-5 relative (the f32 tier).  Dropout takes the same injected draws in
both packages (``_drawRands``), since their generators differ.  The LSTM
script's ``main`` runs in both packages on the same small IMDB files, its
printed errors and accuracy equal within the same tier."""

import contextlib
import importlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.convert import paramsToNumpy
from puzzlelib_tpu_torch.testlib import _imdb as TImdb
from puzzlelib_tpu_torch.tools import dataslice as Data


BOUND = 1e-5


def _jax():
    """The JAX package's pieces; the twins skip where it does not import, as
    on the card's machine."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    from puzzlelib_tpu import cost, handlers, optimizers
    from puzzlelib_tpu.backend import gpuarray
    from puzzlelib_tpu.optimizers import hooks

    return handlers, cost, optimizers, hooks, gpuarray


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()

    return np.asarray(value.get() if hasattr(value, "get") else value, dtype=np.float32)


def _close(got, want, bound=BOUND):
    got, want = _host(got), _host(want)
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def _table(jnet):
    return {name: var.data.get() for var, names in jnet.getVarTable().items() for name in names}


class _Draws:
    """Seeded uint32 draws per dropout, in the order it asks for them."""

    def __init__(self, seed):
        self.seed, self.calls = seed, {}

    def inject(self, mod, name, asTensor):
        def draw(size):
            call = self.calls[name] = self.calls.get(name, 0) + 1
            rng = np.random.RandomState([self.seed, call, sum(map(ord, name))])
            return asTensor(rng.randint(0, 2 ** 32, size=size, dtype=np.uint64).astype(np.uint32))

        mod._drawRands = draw


def _injectDropouts(jnet, tnet, seed=11):
    jgpu = _jax()[4]
    jdraws, tdraws = _Draws(seed), _Draws(seed)
    jdrops = [mod for mod in jnet.graph if type(mod).__name__ == "Dropout"]
    tdrops = [mod for mod in tnet.graph if isinstance(mod, T.Dropout)]
    assert len(jdrops) == len(tdrops)

    for i, (jmod, tmod) in enumerate(zip(jdrops, tdrops)):
        jdraws.inject(jmod, "drop%d" % i, jgpu.to_gpu)
        tdraws.inject(tmod, "drop%d" % i, lambda ary: torch.from_numpy(ary.astype(np.int64)))

    return len(tdrops)


def _jaxRun(script):
    """(net, trainer) of the JAX package as the root script's ``main`` sets
    them up, the net from ``np.random.seed`` of the script (the IMDB
    scripts' from 0, as the port's twin builds them)."""
    JH, JCost, JOpt, JHooks, _ = _jax()

    if script == "cnnmnistlenet":
        from puzzlelib_tpu.models.nets.lenet import loadLeNet

        np.random.seed(1234)
        net = loadLeNet(None, initscheme=None)
        optimizer = JOpt.MomentumSGD()
        optimizer.setupOn(net, useGlobalState=True)
        optimizer.learnRate, optimizer.momRate = 0.1, 0.9
        return net, JH.Trainer(net, JCost.CrossEntropy(maxlabels=10), optimizer)

    net = importlib.import_module("testlib." + script).buildNet
    np.random.seed(1234 if script.startswith("cnncifar10") else 0)
    net = net()

    if script == "cnncifar10nin":
        optimizer = JOpt.MomentumSGD(learnRate=0.1, momRate=0.9)
        optimizer.addHook(JHooks.WeightDecay(0.0001))
        optimizer.setupOn(net, useGlobalState=True)
        return net, JH.Trainer(net, JCost.CrossEntropy(maxlabels=10), optimizer)

    if script == "cnncifar10simple":
        optimizer = JOpt.MomentumSGD()
        optimizer.setupOn(net, useGlobalState=True)
        optimizer.learnRate, optimizer.momRate = 0.01, 0.9
        return net, JH.Trainer(net, JCost.CrossEntropy(maxlabels=10), optimizer)

    optimizer = JOpt.Adam(alpha=1e-3)
    optimizer.setupOn(net, useGlobalState=True)
    return net, JH.Trainer(net, JCost.BCE(), optimizer, batchsize=32)


def _portRun(script):
    """(net, trainer) of the port's counterpart: ``buildTraining`` of the
    CNN scripts, ``_imdb.buildTraining`` on the IMDB scripts' ``buildNet``
    from ``np.random.seed(0)``."""
    module = importlib.import_module("puzzlelib_tpu_torch.testlib." + script)
    if hasattr(module, "buildTraining"):
        net, _, trainer, _ = module.buildTraining()
        return net, trainer

    np.random.seed(0)
    net = module.buildNet()
    return net, TImdb.buildTraining(net)[0]


def _rows(script, count, seed):
    """``count`` seeded rows and labels of the script's data."""
    rng = np.random.RandomState(seed)
    if script == "cnnmnistlenet":
        return rng.rand(count, 1, 28, 28).astype(np.float32), rng.randint(0, 10, size=count).astype(np.int32)

    if script.startswith("cnncifar10"):
        return rng.randn(count, 3, 32, 32).astype(np.float32), rng.randint(0, 10, size=count).astype(np.int32)

    widths = importlib.import_module("puzzlelib_tpu_torch.testlib." + script)
    tokens = rng.randint(0, widths.NUMWORDS, size=(count, widths.MAXLEN)).astype(np.int32)
    return tokens, rng.randint(0, 2, size=count).astype(np.int32)


SCRIPTS = ("cnnmnistlenet", "cnncifar10nin", "cnncifar10simple", "rnnimdbtrain", "birnnimdbtrain", "cnnimdbtrain")


@pytest.mark.parametrize("script", SCRIPTS)
def testScriptNetTwin(script):
    """The script's net and recipe in both packages from one numpy seed:
    the same weights; one forward of 4 rows in train mode; then 2 steps of
    4 through ``Trainer``: the same losses and weights."""
    _, _, _, _, jgpu = _jax()
    jnet, jtrainer = _jaxRun(script)
    tnet, ttrainer = _portRun(script)

    table = _table(jnet)
    tables = paramsToNumpy(tnet)
    assert sorted(tables) == sorted(table)
    assert all(np.array_equal(ary, table[name]) for name, ary in tables.items())
    drops = _injectDropouts(jnet, tnet)
    assert drops == {"cnncifar10nin": 2, "birnnimdbtrain": 1, "cnnimdbtrain": 2}.get(script, 0)

    x, _ = _rows(script, 4, seed=1)
    _close(tnet(torch.from_numpy(x)), jnet(jgpu.to_gpu(x)).get())

    x, y = _rows(script, 8, seed=2)
    losses = {}
    for name, trainer in (("jax", jtrainer), ("port", ttrainer)):
        losses[name] = []
        trainer.batchsize = 4
        trainer.onBatchFinish = lambda h, out=losses[name]: out.append(h.cost.getError())
        np.random.seed(5)
        trainer.trainFromHost(x, y, macroBatchSize=len(x))

    assert len(losses["port"]) == 2
    assert np.allclose(losses["port"], losses["jax"], rtol=BOUND, atol=0.0), losses

    jtable = _table(jnet)
    for name, ary in paramsToNumpy(tnet).items():
        _close(ary, jtable[name])


def testLstmScriptMainTwin(tmp_path, monkeypatch):
    """``rnnimdbtrain.main`` of both packages on the same small IMDB files
    (20 + 12 reviews, a word index from 0 that covers the 20000-word
    vocabulary), ``_imdb.TRAIN_SPLIT`` cut to 20 in both, 2 epochs from one
    numpy seed: the same printed train errors and accuracies."""
    _jax()
    from testlib import _imdb as JImdb
    from testlib import rnnimdbtrain as JLstm
    from puzzlelib_tpu_torch.testlib import rnnimdbtrain as TLstm

    printed = {}
    for name, imdb, script in (("jax", JImdb, JLstm), ("port", TImdb, TLstm)):
        path = tmp_path / name
        path.mkdir()
        Data.writeImdb(str(path), train=20, test=12, words=300, lengths=(3, 40, 120))
        with open(path / "imdb_word_index.json", "w") as f:
            json.dump({"w%d" % i: i for i in range(script.NUMWORDS)}, f)

        monkeypatch.setattr(imdb, "TRAIN_SPLIT", 20)
        out = io.StringIO()
        np.random.seed(7)
        with contextlib.redirect_stdout(out):
            script.main(epochs=2, datapath=str(path))
        printed[name] = out.getvalue()

    numbers = {name: [float(v) for v in re.findall(r"(?:Train error|Accuracy): (\S+)", text)]
               for name, text in printed.items()}
    assert len(numbers["port"]) == 4, printed["port"]
    assert np.allclose(numbers["port"], numbers["jax"], rtol=BOUND, atol=0.0), numbers
    assert os.path.exists(tmp_path / "port" / "imdb.hdf")
