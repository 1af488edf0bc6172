"""``puzzlelib_tpu_torch/testlib/optimizenet.py`` against the root script:
``main(batchsize=1, looplength=1)`` of both packages, VGG-16 at full size
(224 x 224), each ``timeKernel`` making two calls (the untimed one and the
timed one): the weights after the eager ``Trainer.train`` calls and after
the ``FusedTrainer.train`` calls within 1e-5 of max(1, max |ref|) of the
JAX package's, the f32 tier.

The script builds VGG-16 under the "none" scheme (uninitialised memory in
the port), which only its times ignore: both ``main``s take the JAX
package's He weights from ``np.random.seed(0)`` instead (``loadVGG``
replaced), and draw their batch from ``np.random.seed(1)``."""

import importlib

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch.convert import paramsFromNumpy, paramsToNumpy
from puzzlelib_tpu_torch.models.nets import loadVGG as tLoadVGG
from puzzlelib_tpu_torch.testlib import optimizenet as TOptimize


BOUND = 1e-5


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    monkeypatch.setattr(TConfig, "device", "cpu")


def _jtable(jnet):
    return {name: np.asarray(var.data.get()) for var, names in jnet.getVarTable().items() for name in names}


def testMainTwin(monkeypatch):
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    JOptimize = importlib.import_module("testlib.optimizenet")
    from puzzlelib_tpu.models.nets.vgg import loadVGG as jLoadVGG

    np.random.seed(0)
    jnet = jLoadVGG(None, "16", initscheme="he")
    start = _jtable(jnet)

    def jaxVGG(modelpath, layers):
        np.random.seed(1)
        return jnet

    def portVGG(modelpath, layers):
        net = tLoadVGG(modelpath, layers)
        paramsFromNumpy(net, start)
        np.random.seed(1)
        return net

    nets, eager = {}, {}
    for name, script, loader, table in (("jax", JOptimize, jaxVGG, _jtable), ("port", TOptimize, portVGG,
                                                                             paramsToNumpy)):
        def load(modelpath, layers, loader=loader, name=name):
            return nets.setdefault(name, loader(modelpath, layers))

        class Snapshot(script.FusedTrainer):
            """The fused trainer, built after the eager calls: it keeps the
            weights they left."""

            def __init__(self, net, *args, table=table, name=name, **kwargs):
                eager[name] = {key: ary.copy() for key, ary in table(net).items()}
                super().__init__(net, *args, **kwargs)

        monkeypatch.setattr(script, "loadVGG", load)
        monkeypatch.setattr(script, "FusedTrainer", Snapshot)
        script.main(batchsize=1, looplength=1)

    for tables in (eager, {"jax": _jtable(nets["jax"]), "port": paramsToNumpy(nets["port"])}):
        assert sorted(tables["port"]) == sorted(tables["jax"])
        moved = 0
        for key, want in tables["jax"].items():
            got = tables["port"][key]
            assert np.isfinite(want).all()
            assert np.abs(got - want).max() <= BOUND * max(1.0, np.abs(want).max()), key
            moved += not np.array_equal(want, start[key])

        assert moved == len(start)


def testBuildRunInBf16():
    """``buildRun(batchsize, dtype=torch.bfloat16)``: VGG-16 in bf16 with a
    bf16 batch and int32 labels, SGD in global state over one bf16 flat
    buffer (the dtype the card's phase trains in, where K2, K2-bwd and K3
    take its 10 Winograd convs)."""
    np.random.seed(1)
    net, batch, labels, optimizer, cost = TOptimize.buildRun(batchsize=2, dtype=torch.bfloat16)

    assert batch.dtype == torch.bfloat16 and tuple(batch.shape) == (2, 3, 224, 224)
    assert labels.dtype == torch.int32 and 0 <= int(labels.min()) and int(labels.max()) < 1000
    assert set(optimizer.shParams) == {torch.bfloat16} and cost.maxlabels == 1000
