"""The model-parallel slice (``puzzlelib_tpu_torch/tools/mpslice.py``), as
``chip_smoke.py`` [model-parallel] runs it, here on the CPU at a cut depth:
the MoE trunk's GPipe training on four ranks against the one-process
microbatched oracle, expert and sequence parallelism on the same ranks,
and LeNet's tensor-parallel and ZeRO fused steps on a one-rank mesh against
the steps over no mesh.  The card-only case (``cuda`` marker) runs the
latter on a one-rank NCCL mesh, where each step is a CUDA graph."""

import time

import numpy as np
import pytest

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch.grid import runGrid
from puzzlelib_tpu_torch.tools import cnnslice, gridslice, moeslice, mpslice


TIMEOUT = 120
RANKS = 4


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    monkeypatch.setattr(TConfig, "device", "cpu")


def _rel(got, want):
    return max(float(np.abs(got[name] - value).max()) / max(1.0, float(np.abs(value).max()))
               for name, value in want.items())


def _prefixed(node, prefix):
    return {key[len(prefix):]: value for key, value in node.items() if key.startswith(prefix)}


def testPipeSliceAgainstOracle(tmp_path):
    """Two steps of 128 (one epoch of 256 rows) on four ranks: the ranks'
    weights bit-equal, the weights after step 1 and at the end and the
    losses within 1e-5 of the oracle's (the eager pipe run microbatch by
    microbatch), the validation output equal to the eager pipe's on each
    microbatch, ``SwitchMoE.distributedForward`` equal to the eager layer
    and ``seqParallelMLP`` to the dense MLP."""
    data = moeslice.data(trainRows=256, valRows=256)
    runGrid(mpslice.pipeNode, RANKS, data, 1, tmp_path, time.time(), timeout=TIMEOUT)
    nodes = gridslice.load(tmp_path, "pipe", RANKS)

    finals = [_prefixed(node, "final/") for node in nodes]
    assert all(np.array_equal(node[name], finals[0][name]) for node in finals[1:] for name in finals[0])

    steps, final = mpslice.oracle(data, 1)
    assert _rel(_prefixed(nodes[0], "first/"), steps.first) <= 1e-5
    assert _rel(finals[0], final) <= 1e-5
    assert np.abs(nodes[0]["losses"] - np.array(steps.losses)).max() <= 1e-5 * np.abs(steps.losses).max()

    for node in nodes:
        assert float(node["eagerGap"]) <= 1e-5
        assert np.abs(node["expert/out"] - node["expert/eager"]).max() <= 1e-5
        assert np.array_equal(node["expert/aux"], node["expert/eagerAux"])
        assert float(node["seq/gap"]) <= 1e-4
        assert float(node["handoffMs"]) > 0.0


def testFusedSliceOneRank(tmp_path):
    """LeNet's tensor-parallel (``MomentumSGD``) and ZeRO (``Adam``) fused
    steps over a one-rank (data, model) mesh give the bits of the steps
    over no mesh; on the CPU nothing is recorded."""
    data, labels = cnnslice.data("lenet", 2 * mpslice.FUSED_BATCH)
    runGrid(mpslice.fusedNode, 1, data, labels, 2, tmp_path, timeout=TIMEOUT)
    got = gridslice.load(tmp_path, "fused", 1)[0]

    for kind in ("tp", "zero"):
        single = _prefixed(got, kind + "/single/")
        names = [name for name in single if "." in name]
        assert names and all(np.array_equal(got["%s/mesh/%s" % (kind, name)], single[name]) for name in names)
        assert int(got[kind + "/mesh/captures"]) == int(got[kind + "/single/captures"]) == 0


@pytest.mark.cuda
def testFusedSliceOneRankNccl(monkeypatch, tmp_path):
    """On card 0 over a one-rank NCCL (data, model) mesh: each sharded step
    is bit-equal to the step over no mesh, one graph is recorded for each,
    and K1 runs as often in both."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sharded step records its NCCL calls in a CUDA graph")

    monkeypatch.setattr(TConfig, "device", None)
    data, labels = cnnslice.data("lenet", 4 * mpslice.FUSED_BATCH)
    runGrid(mpslice.fusedNode, 1, data, labels, 4, tmp_path, timeout=TIMEOUT)
    got = gridslice.load(tmp_path, "fused", 1)[0]

    for kind in ("tp", "zero"):
        single = _prefixed(got, kind + "/single/")
        for name in [name for name in single if "." in name]:
            assert np.array_equal(got["%s/mesh/%s" % (kind, name)], single[name]), name

        assert int(got[kind + "/mesh/captures"]) == int(got[kind + "/single/captures"]) == 1
        assert int(got[kind + "/mesh/launches"]) == int(got[kind + "/single/launches"]) >= 2 * 4
