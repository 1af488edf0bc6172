"""``puzzlelib_tpu_torch/testlib/transformertrain.py`` against the root
script: ``main`` of both packages for 1 epoch on the same small IMDB files
(a word index from 0 that covers the 20000-word vocabulary), as
``testLstmScriptMainTwin`` runs ``rnnimdbtrain``.

The root script cuts its data at row 25000 with literal slices; the files
hold 20 + 12 reviews, so the loader's arrays are handed to both ``main``s
as an array whose ``[:25000]`` and ``[25000:]`` cut at row 20 (``_Cut``).
At a batch of 5, ``FusedTrainer`` groups the 4 batches as one dispatch of
4 steps.  The printed train error and accuracy of the
port within 1e-5 of the JAX package's (the f32 tier).  The weights are
not compared here: entries of ``Wq`` and ``Wk`` whose gradient lies near
Adam's epsilon, and ``bk`` (an exact zero gradient), take Adam steps that
their last bits decide (``test_torch_fused._adamSlack``), which moves the
later steps' inputs, and the fused trainer leaves no per-step gradient to
bound that by; the step-level twin of this net's weights under Adam is
``test_torch_fused.testFusedStepTwin``."""

import contextlib
import importlib
import io
import json
import re

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch.convert import paramsToNumpy
from puzzlelib_tpu_torch.testlib import transformertrain as TTrain
from puzzlelib_tpu_torch.tools import dataslice as Data


BOUND = 1e-5
ROOT_SPLIT, SPLIT = 25000, 20


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    monkeypatch.setattr(TConfig, "device", "cpu")


class _Cut(np.ndarray):
    """An array whose ``[:25000]`` and ``[25000:]`` cut at row ``SPLIT``."""

    def __getitem__(self, key):
        if key == slice(None, ROOT_SPLIT, None):
            key = slice(None, SPLIT)
        elif key == slice(ROOT_SPLIT, None, None):
            key = slice(SPLIT, None)

        return np.asarray(self)[key]


def _cutLoader(Loader):
    class CutLoader(Loader):
        def load(self, *args, **kwargs):
            data, labels, vocabulary = super().load(*args, **kwargs)
            return np.asarray(data[:]).view(_Cut), np.asarray(labels[:]).view(_Cut), vocabulary

    return CutLoader


def testMainTwin(tmp_path, monkeypatch):
    """``main(epochs=1, batchsize=5)`` of both packages, the "xla" attention
    (the script's) in f32, from one numpy seed: the printed train error and
    accuracy, and the same variables."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    JTrain = importlib.import_module("testlib.transformertrain")

    printed, nets = {}, {}
    for name, script in (("jax", JTrain), ("port", TTrain)):
        path = tmp_path / name
        path.mkdir()
        Data.writeImdb(str(path), train=SPLIT, test=12, words=300, lengths=(3, 40, 120))
        with open(path / "imdb_word_index.json", "w") as f:
            json.dump({"w%d" % i: i for i in range(TTrain.NUMWORDS)}, f)

        monkeypatch.setattr(script, "IMDBLoader", _cutLoader(script.IMDBLoader))
        build = script.buildNet
        monkeypatch.setattr(script, "buildNet", lambda *args, build=build, name=name, **kwargs:
                            nets.setdefault(name, build(*args, **kwargs)))

        out = io.StringIO()
        np.random.seed(7)
        with contextlib.redirect_stdout(out):
            script.main(epochs=1, datapath=str(path), batchsize=5)
        printed[name] = [float(v) for v in re.findall(r"(?:Train error|accuracy): (\S+)", out.getvalue())]

    assert len(printed["port"]) == len(printed["jax"]) == 2, printed
    assert np.allclose(printed["port"], printed["jax"], rtol=BOUND, atol=0.0), printed

    assert sorted(paramsToNumpy(nets["port"])) == sorted(name for names in nets["jax"].getVarTable().values()
                                                         for name in names)


def testTrainSplitsAndRoutes():
    """``train`` on seeded token rows at a split of 8: one epoch on each
    attention route ("xla" in f32, "flash" in bf16, its plain version on
    the CPU), finite errors and accuracies in [0, 1]."""
    rng = np.random.RandomState(3)
    data = rng.randint(0, TTrain.NUMWORDS, size=(12, TTrain.MAXLEN)).astype(np.int32)
    labels = rng.randint(0, 2, size=12).astype(np.int32)

    for algo, dtype in (("xla", None), ("flash", torch.bfloat16)):
        np.random.seed(0)
        errors, accuracies = TTrain.train(data, labels, epochs=1, batchsize=4, attnAlgo=algo, dtype=dtype, split=8)
        assert len(errors) == len(accuracies) == 1
        assert np.isfinite(errors).all() and 0.0 <= accuracies[0] <= 1.0
