"""``FusedStep(mesh=...)`` (``puzzlelib_tpu_torch/fused.py``) against the
JAX package's mesh step and against the port's step over no mesh.

The port's ranks are grid nodes on the CPU over gloo, each with a
``DeviceMesh`` of one "data" axis over the grid; their targets live in
``gridnodes.py``.  Each rank runs its step on its share of the global batch
and averages the gradients over the axis; the JAX package's step runs GSPMD
over as many of the 8 virtual CPU devices of ``conftest.py``.  Everything
is held at the f32 tier, within 1e-5 of max(1, max |want|), and the ranks
to each other bit for bit.  Every grid passes a process-group ``timeout``.
The card-only case (``cuda`` marker) runs a one-rank NCCL mesh whose CUDA
graph holds the all-reduce."""

import numpy as np
import pytest

import gridnodes
from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch.grid import runGrid
from puzzlelib_tpu_torch.tools import gridslice


TIMEOUT = 60
BOUND = 1e-5


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    monkeypatch.setattr(TConfig, "device", "cpu")


def _jax():
    """The JAX package's pieces; the twins skip where it does not import."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    import jax
    from jax.sharding import Mesh
    from puzzlelib_tpu import containers, cost, fused, modules, optimizers

    return jax, Mesh, modules, containers, cost, optimizers, fused


def _close(got, want, bound=BOUND):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def _meshRun(tmp_path, size, netName, data, target, steps, useGlobalState=True, grouped=False,
             countCollectives=False):
    """The ranks' results (``gridnodes.meshTwin``), after checking that they
    are bit-equal."""
    runGrid(gridnodes.meshTwin, size, netName, data, target, steps, useGlobalState, tmp_path, grouped=grouped,
            countCollectives=countCollectives, timeout=TIMEOUT)

    nodes = gridslice.load(tmp_path, "mesh", size)
    for key in nodes[0]:
        for node in nodes[1:]:
            assert np.array_equal(node[key], nodes[0][key]), key

    return nodes[0]


def _jaxMesh(netName, data, target, steps, devices, useGlobalState=True, grouped=False):
    """The JAX package's ``FusedStep`` over a mesh of ``devices`` virtual
    devices (or over none where ``devices`` is None): {name: weight},
    {module.attr: value}, the mean error."""
    jax, Mesh, M, C, JCost, JOpt, jfused = _jax()

    net = gridnodes.build(netName, M, C)
    optimizer = JOpt.MomentumSGD(learnRate=0.05)
    optimizer.setupOn(net, useGlobalState=useGlobalState)
    cost = JCost.MSE()

    mesh = None if devices is None else Mesh(np.array(jax.devices()[:devices]), axis_names=("data", ))
    step = jfused.FusedStep(net, cost, optimizer, mesh=mesh)
    if grouped:
        step.many(data, target, steps)
    else:
        for _ in range(steps):
            step(data, target)

    weights = {name: np.asarray(var.data.get(), np.float32) for var, names in net.getVarTable().items()
               for name in names}
    attrs = {"%s.%s" % (mod.name, name): np.asarray(attr.get(), np.float32)
             for mod in net.modules.values() for name, attr in mod.attrs.items()}
    return weights, attrs, cost.getMeanError()


def _assertTwin(got, route, want):
    weights, attrs, error = want
    for name, value in weights.items():
        _close(got["%s/%s" % (route, name)], value)

    for name, value in attrs.items():
        _close(got["%s/attr/%s" % (route, name)], value)

    _close(got["%s/error" % route], error)


def _parallelData(rows, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(rows, 8).astype(np.float32), rng.randn(rows, 4).astype(np.float32)


@pytest.mark.parametrize("useGlobalState", [True, False])
def testFusedMeshDataParallelTwin(useGlobalState, tmp_path):
    """``tests/test_parallel.py:75-122`` on four ranks: 3 mesh steps of 16
    rows (4 a rank) within the f32 tier of the JAX package's mesh step over
    four devices and of the port's step over no mesh, in global and in
    local state."""
    data, target = _parallelData(16, 1)
    got = _meshRun(tmp_path, 4, "parallel7", data, target, 3, useGlobalState)

    _assertTwin(got, "mesh", _jaxMesh("parallel7", data, target, 3, 4, useGlobalState))
    for key in [key for key in got if key.startswith("single/")]:
        _close(got["mesh/" + key[len("single/"):]], got[key])


def testFusedMeshManyTwin(tmp_path):
    """``many`` over the mesh: 3 steps of 16 rows in one call, each step's
    rows shared over four ranks, against the JAX package's ``many`` over
    four devices."""
    data, target = _parallelData(48, 2)
    got = _meshRun(tmp_path, 4, "parallel7", data, target, 3, grouped=True)

    _assertTwin(got, "mesh", _jaxMesh("parallel7", data, target, 3, 4, grouped=True))
    _assertTwin(got, "single", _jaxMesh("parallel7", data, target, 3, None, grouped=True))


def testFusedMeshRaggedBatchTwin(tmp_path):
    """``tests/test_parallel.py:235-285``: a batch of 2 * 4 + 3 rows does not
    divide over four ranks, so every rank runs it whole: the weights and the
    error of the JAX package's ragged mesh step and of the single step."""
    data, target = _parallelData(2 * 4 + 3, 11)
    got = _meshRun(tmp_path, 4, "parallel17", data, target, 1)

    _assertTwin(got, "mesh", _jaxMesh("parallel17", data, target, 1, 4))
    assert all(np.array_equal(got[key], got["mesh/" + key[len("single/"):]]) for key in got
               if key.startswith("single/"))


def _bnData(seed=9):
    rng = np.random.RandomState(seed)
    return rng.randn(8, 3, 8, 8).astype(np.float32), rng.randn(8, 4).astype(np.float32)


def testFusedMeshBatchNormTwin(tmp_path):
    """A conv net with ``BatchNorm2D`` on two ranks, 3 steps of 8 rows: the
    batch statistics are the global batch's, so the weights and the running
    mean and variance match the JAX package's mesh step over two devices and
    the single-device step."""
    data, target = _bnData()
    got = _meshRun(tmp_path, 2, "bn", data, target, 3)

    _assertTwin(got, "mesh", _jaxMesh("bn", data, target, 3, 2))
    _assertTwin(got, "single", _jaxMesh("bn", data, target, 3, None))
    assert "mesh/attr/bn.mean" in got


@pytest.mark.parametrize("useGlobalState, want", [(True, 1 + 1 + 2), (False, 6 + 1 + 2)])
def testFusedMeshCollectivesPerStep(useGlobalState, want, tmp_path):
    """The counterpart of ``testMeshStepHloContainsCollectives``: a mesh step
    issues one mean-reduce per gradient root buffer (one flat buffer under
    global state, the six variables' under local state), the error's sum,
    and the batch norm's two sums (forward and backward)."""
    data, target = _bnData()
    got = _meshRun(tmp_path, 2, "bn", data, target, 1, useGlobalState, countCollectives=True)

    assert int(got["collectives"]) == want


def testFusedStepStateShardingsRaises(tmp_path):
    """The sharding specs over a real mesh (model parallelism,
    ``test_torch_tensorparallel.py``) refuse what they cannot place: an
    optimizer in global state, and a list that does not hold one placement
    for each state buffer, each with a ``ValueError`` that says so."""
    runGrid(gridnodes.stateShardings, 2, tmp_path, timeout=TIMEOUT)
    got = gridslice.load(tmp_path, "shardings", 2)

    for node in got:
        assert "stateShardings take an optimizer in local state" in str(node["globalState"])
        assert "stateShardings holds 0 placements, the step has 14 state buffers" in str(node["length"])


@pytest.mark.cuda
def testMeshOneRankNcclGraph(monkeypatch, tmp_path):
    """A one-rank NCCL mesh on card 0 (``runGrid`` of one node): LeNet's mesh
    step is bit-equal to the step over no mesh, one graph is recorded for
    each, K1 runs in the replays, and the profiler sees NCCL's kernel in a
    replay of the mesh step."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the mesh step records NCCL calls in a CUDA graph")

    monkeypatch.setattr(TConfig, "device", None)
    rng = np.random.RandomState(7)
    data = rng.rand(4 * 128, 1, 28, 28).astype(np.float32)
    labels = rng.randint(0, 10, size=4 * 128).astype(np.int32)

    runGrid(gridslice.meshNode, 1, data, labels, 4, tmp_path, timeout=TIMEOUT)
    got = gridslice.load(tmp_path, "mesh", 1)[0]

    for key in [key for key in got if key.startswith("single/") and "." in key]:
        assert np.array_equal(got["mesh/" + key[len("single/"):]], got[key]), key

    assert int(got["mesh/captures"]) == int(got["single/captures"]) == 1
    assert int(got["mesh/launches"]) == int(got["single/launches"]) >= 2 * 4
    assert any("nccl" in name.lower() or "onerank" in name.lower() for name in got["kernels"])
