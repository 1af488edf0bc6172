"""The grid (``puzzlelib_tpu_torch/parallel/grid.py``) and the optimizers'
``nodeinfo`` against the JAX package's grid, and the multi-GPU scripts
against the JAX recipe.

The port's nodes are processes on the CPU over gloo; their targets live in
``gridnodes.py`` (a spawned node imports its target by module name) and
write what they computed into a temporary directory.  The JAX package's grid
runs its nodes as threads in this process, on the 8 virtual CPU devices of
``conftest.py``; its nodes build their nets under a lock, since threads
share numpy's seed.  Everything is held at the f32 tier, within 1e-5 of
max(1, max |want|), and the nodes of one grid to each other bit for bit.
Every grid passes a process-group ``timeout``.  The card-only case
(``cuda`` marker) runs two nodes on one card over gloo."""

import threading
import time

import numpy as np
import pytest
import torch

import gridnodes
from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch.grid import GridError, runGrid
from puzzlelib_tpu_torch.tools import gridslice


TIMEOUT = 60
BOUND = 1e-5

# node values whose f32 mean rounds to another bf16 than a bf16 sum gives
BF16_VALUES = [1.0, 2 ** -8, 2 ** -8, 2 ** -8]

# the multi-GPU script twins: 2 nodes, one step of 64 an epoch, 50 rows
# validated a node
SCRIPT_NODES, SCRIPT_EPOCHS, SCRIPT_TRAIN, SCRIPT_VAL = 2, 3, 128, 100


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Run the grids on the CPU, also on a machine with a card (the
    card-only case sets "cuda" itself)."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _jax():
    """The JAX package's pieces; the twins skip where it does not import."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    from puzzlelib_tpu import containers, cost, handlers, modules, optimizers
    from puzzlelib_tpu.backend import gpuarray
    from puzzlelib_tpu.grid import runGrid as jaxRunGrid

    return modules, containers, cost, handlers, optimizers, gpuarray, jaxRunGrid


def _close(got, want, bound=BOUND):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def _bitEqual(nodes, keys):
    for key in keys:
        for node in nodes[1:]:
            assert np.array_equal(node[key], nodes[0][key]), key


def _jaxWeights(net):
    return {name: np.asarray(var.data.get(), np.float32) for var, names in net.getVarTable().items()
            for name in names}


def _parallelData():
    """The data of ``tests/test_parallel.py``'s grid test."""
    np.random.seed(0)
    return np.random.randn(16, 8).astype(np.float32), np.random.randn(16, 4).astype(np.float32)


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    """One four-node grid of ``gridnodes.meanAndSum``."""
    outdir = tmp_path_factory.mktemp("collectives")
    previous, TConfig.device = TConfig.device, "cpu"
    try:
        runGrid(gridnodes.meanAndSum, 4, BF16_VALUES, outdir, timeout=TIMEOUT)
    finally:
        TConfig.device = previous

    return gridslice.load(outdir, "collectives", 4)


def testGridMeanValueAndSumTensorTwin(collectives):
    """``meanValue`` gives exactly 1.5 and ``sumTensor`` 2.5 on every node;
    the bf16 mean goes through f32 and gives the bits of the JAX package's
    ``_jittedReducer``, not those of a bf16 sum."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    _jax()
    from puzzlelib_tpu.parallel.grid import _jittedReducer

    for node in collectives:
        assert float(node["mean"]) == 1.5
        assert (node["f32"] == 2.5).all()

    devices = jax.devices()[:4]
    mesh = Mesh(np.array(devices), ("grid", ))
    stacked = jax.device_put(jnp.asarray(BF16_VALUES, jnp.bfloat16).reshape(4, 1), NamedSharding(mesh, P("grid")))
    want = float(np.asarray(_jittedReducer("mean", 4, tuple(d.id for d in devices), mesh)(stacked), np.float32)[0])

    bf16Sum = torch.tensor(BF16_VALUES).to(torch.bfloat16)
    acc = bf16Sum[0]
    for value in bf16Sum[1:]:
        acc = acc + value
    assert float(acc * 0.25) != want

    for node in collectives:
        assert float(node["bf16"]) == want


def testGridBroadcastBuffer(collectives):
    """Every node holds node 0's f32 and bf16 buffers after
    ``broadcastBuffer``."""
    want = np.arange(6, dtype=np.float32)
    wantHalf = torch.tensor(want / 3).to(torch.bfloat16).float().numpy()

    for node in collectives:
        assert np.array_equal(node["buffer"], want)
        assert np.array_equal(node["half"], wantHalf)


def testGridNodeImportsNoJax(collectives):
    """A spawned node holds none of ``jax``, ``jaxlib``, ``ml_dtypes`` and
    ``puzzlelib_tpu``, and runs on the CPU as its caller asked."""
    for node in collectives:
        assert node["leaked"].size == 0, node["leaked"]
        assert str(node["device"]) == "cpu"


def testGridNodeFailureRaises():
    """A node that raises has its exception raised in the caller, with the
    node's traceback, within seconds; the node waiting for it in a
    collective is terminated."""
    started = time.perf_counter()
    with pytest.raises(ValueError, match="node 1 failed on purpose") as info:
        runGrid(gridnodes.failing, 2, 1, timeout=TIMEOUT)

    assert time.perf_counter() - started < 30
    assert any("raised in grid node 1" in note for note in info.value.__notes__)


def testGridRefusesWhatItCannotRun(monkeypatch):
    """A device index the machine lacks, a device list of another length and
    a target that cannot cross to a node raise ``GridError`` before a node
    starts."""
    monkeypatch.setattr(TConfig, "device", None)
    with pytest.raises(GridError, match="device %d asked for" % torch.cuda.device_count()):
        runGrid(gridnodes.failing, 1, 0, devices=[torch.cuda.device_count()], timeout=TIMEOUT)

    monkeypatch.setattr(TConfig, "device", "cpu")
    with pytest.raises(GridError, match="3 devices given for a grid of 2"):
        runGrid(gridnodes.failing, 2, 0, devices=[0, 0, 0], timeout=TIMEOUT)

    with pytest.raises(GridError, match="top level of an importable module"):
        runGrid(lambda nodeinfo: None, 2, timeout=TIMEOUT)


def _jaxGrid(jaxRunGrid, size, node):
    """``node(nodeinfo, lock)`` on the JAX package's thread grid; the
    nodes' results by index."""
    lock, results = threading.Lock(), {}

    def target(nodeinfo):
        results[nodeinfo.index] = node(nodeinfo, lock)

    jaxRunGrid(target, size)
    return results


def testGridDataParallelTrainingTwin(tmp_path):
    """``tests/test_parallel.py:26-72`` in the port: the two nodes'
    weights are bit-equal, and match the JAX grid's and the port's single
    process on the full batch."""
    M, C, JCost, _, JOpt, jgpu, jaxRunGrid = _jax()
    from puzzlelib_tpu_torch import cost as TCost, optimizers as TOpt
    from puzzlelib_tpu_torch.backend import gpuarray

    fullData, fullTarget = _parallelData()
    runGrid(gridnodes.dataParallel, 2, fullData, fullTarget, 5, tmp_path, timeout=TIMEOUT)
    nodes = gridslice.load(tmp_path, "dataparallel", 2)
    _bitEqual(nodes, nodes[0].keys())

    def jaxNode(nodeinfo, lock):
        with lock:
            np.random.seed(42)
            seq = gridnodes.parallelNet(M, C)

        optimizer = JOpt.MomentumSGD(learnRate=0.05, nodeinfo=nodeinfo)
        optimizer.setupOn(seq, useGlobalState=True)

        rows = slice(nodeinfo.index * 8, (nodeinfo.index + 1) * 8)
        data, target = jgpu.to_gpu(fullData[rows]), jgpu.to_gpu(fullTarget[rows])

        mse = JCost.MSE()
        for _ in range(5):
            error, grad = mse(seq(data), target)
            optimizer.zeroGradParams()
            seq.backward(grad)
            optimizer.update()

        return _jaxWeights(seq), nodeinfo.meanValue(error)

    jaxWeights, jaxError = _jaxGrid(jaxRunGrid, 2, jaxNode)[0]

    np.random.seed(42)
    single = gridnodes.parallelNet()
    optimizer = TOpt.MomentumSGD(learnRate=0.05)
    optimizer.setupOn(single, useGlobalState=True)
    mse = TCost.MSE()
    for _ in range(5):
        _, grad = mse(single(gpuarray.to_gpu(fullData)), gpuarray.to_gpu(fullTarget))
        optimizer.zeroGradParams()
        single.backward(grad)
        optimizer.update()

    singleWeights = gridnodes.weights(single)
    assert sorted(jaxWeights) == sorted(singleWeights)
    for name, want in jaxWeights.items():
        _close(nodes[0][name], want)
        _close(nodes[0][name], singleWeights[name])

    _close(nodes[0]["error"], jaxError)


def testGridOptimizersTwin(tmp_path):
    """The nine optimizers built with a ``nodeinfo``, 3 steps each on a
    two-node grid: bit-equal between the nodes and within the f32 tier of
    the JAX package's grid run; local state with a ``nodeinfo`` asserts."""
    M, C, JCost, _, JOpt, jgpu, jaxRunGrid = _jax()

    fullData, fullTarget = _parallelData()
    runGrid(gridnodes.optimizerGrid, 2, fullData, fullTarget, 3, tmp_path, timeout=TIMEOUT)
    nodes = gridslice.load(tmp_path, "optimizers", 2)
    _bitEqual(nodes, nodes[0].keys())
    assert all(bool(node["localAsserts"]) for node in nodes)

    def jaxNode(nodeinfo, lock):
        rows = slice(nodeinfo.index * 8, (nodeinfo.index + 1) * 8)
        data, target = jgpu.to_gpu(fullData[rows]), jgpu.to_gpu(fullTarget[rows])

        results = {}
        for name in gridnodes.OPTIMIZERS:
            with lock:
                np.random.seed(42)
                seq = gridnodes.parallelNet(M, C)

            optimizer = getattr(JOpt, name)(nodeinfo=nodeinfo)
            optimizer.setupOn(seq, useGlobalState=True)

            mse = JCost.MSE()
            for _ in range(3):
                _, grad = mse(seq(data), target)
                optimizer.zeroGradParams()
                seq.backward(grad)
                optimizer.update()

            results.update({"%s/%s" % (name, key): value for key, value in _jaxWeights(seq).items()})

        return results

    want = _jaxGrid(jaxRunGrid, 2, jaxNode)[0]
    assert sorted(want) == sorted(key for key in nodes[0] if key != "localAsserts")
    for key, value in want.items():
        _close(nodes[0][key], value)


def testFusedStepRefusesNodeinfo(tmp_path):
    """A ``FusedStep`` over an optimizer built with a ``nodeinfo`` raises,
    naming ``FusedStep(mesh=...)``; the JAX package's trace of the grid's
    exchange fails too."""
    runGrid(gridnodes.fusedRefusesNodeinfo, 1, tmp_path, timeout=TIMEOUT)
    assert "FusedStep(mesh=...)" in str(gridslice.load(tmp_path, "refuses", 1)[0]["message"])


def _scriptRows(name, seed=3):
    rng = np.random.RandomState(seed)
    count = SCRIPT_TRAIN + SCRIPT_VAL
    shape = (count, 1, 28, 28) if name == "mnist" else (count, 3, 32, 32)

    data = rng.rand(*shape).astype(np.float32) if name == "mnist" else rng.randn(*shape).astype(np.float32)
    return data, rng.randint(0, 10, size=count).astype(np.int32)


def _jaxScript(name, data, labels):
    """The root script's recipe, from its pieces, on the JAX package's
    two-node grid: (node 0's weights, its history)."""
    M, C, JCost, JH, JOpt, _, jaxRunGrid = _jax()

    def jaxNode(nodeinfo, lock):
        with lock:
            np.random.seed(1234)
            if name == "mnist":
                from puzzlelib_tpu.models.nets.lenet import loadLeNet
                net = loadLeNet(None, initscheme=None)
            else:
                from testlib.cnncifar10simple import buildNet
                net = buildNet()

        optimizer = JOpt.MomentumSGD(learnRate=0.1 if name == "mnist" else 0.01, momRate=0.9, nodeinfo=nodeinfo)
        optimizer.setupOn(net, useGlobalState=True)

        cost = JCost.CrossEntropy(maxlabels=10)
        trainer = JH.Trainer(net, cost, optimizer, batchsize=128 // nodeinfo.gridsize)
        validator = JH.Validator(net, cost)

        trainPer, valPer = SCRIPT_TRAIN // nodeinfo.gridsize, SCRIPT_VAL // nodeinfo.gridsize
        mine = slice(nodeinfo.index * trainPer, (nodeinfo.index + 1) * trainPer)
        myVal = slice(SCRIPT_TRAIN + nodeinfo.index * valPer, SCRIPT_TRAIN + (nodeinfo.index + 1) * valPer)

        plateau, history = np.inf, []
        for _ in range(SCRIPT_EPOCHS):
            trainer.trainFromHost(data[mine], labels[mine], macroBatchSize=trainPer)
            trerr = nodeinfo.meanValue(cost.getMeanError())
            valerr = nodeinfo.meanValue(validator.validateFromHost(data[myVal], labels[myVal], macroBatchSize=valPer))
            history.append((trerr, valerr))

            if name == "mnist":
                optimizer.learnRate *= 0.9
            else:
                if valerr >= plateau:
                    optimizer.learnRate *= 0.5
                plateau = valerr

        return _jaxWeights(net), np.array(history)

    return _jaxGrid(jaxRunGrid, SCRIPT_NODES, jaxNode)[0]


@pytest.mark.parametrize("name", ["mnist", "cifar10"])
def testMultiGpuScriptTwin(name, tmp_path):
    """``multigpumnist.train`` and ``multigpucifar10.train`` at full width
    on two nodes over 228 seeded rows (3 epochs of one step of 64 a node,
    50 rows validated a node): the nodes bit-equal, and the weights and the
    global errors of every epoch within the f32 tier of the JAX recipe."""
    data, labels = _scriptRows(name)
    runGrid(gridnodes.script, SCRIPT_NODES, name, data, labels, SCRIPT_EPOCHS, (SCRIPT_TRAIN, SCRIPT_VAL), tmp_path,
            timeout=TIMEOUT)
    nodes = gridslice.load(tmp_path, name, SCRIPT_NODES)
    _bitEqual(nodes, [key for key in nodes[0] if key != "losses"])

    wantWeights, wantHistory = _jaxScript(name, data, labels)
    assert sorted(wantWeights) == sorted(key for key in nodes[0] if key not in ("history", "losses"))
    for key, value in wantWeights.items():
        _close(nodes[0][key], value)

    _close(nodes[0]["history"], wantHistory)
    assert len(nodes[0]["losses"]) == SCRIPT_EPOCHS


@pytest.mark.cuda
def testGridTwoNodesShareCardOverGloo(monkeypatch, tmp_path):
    """Two nodes on card 0 (``devices=[0, 0]``, so gloo): the data-parallel
    training of ``tests/test_parallel.py`` gives both nodes the same bits,
    on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the nodes run on card 0")

    monkeypatch.setattr(TConfig, "device", None)
    fullData, fullTarget = _parallelData()
    runGrid(gridnodes.dataParallel, 2, fullData, fullTarget, 5, tmp_path, devices=[0, 0], timeout=TIMEOUT)

    nodes = gridslice.load(tmp_path, "dataparallel", 2)
    _bitEqual(nodes, nodes[0].keys())
    assert all(np.isfinite(node["fc1.W"]).all() for node in nodes)


def testGridSliceAgainstOracle(tmp_path):
    """[grid]'s part (a) at a small size on the CPU: two nodes of
    ``multigpumnist.train`` (``gridslice.mnistNode``) over 640 rows, 5 steps
    of 64 a node, against ``gridslice.oracle``, the single process that
    takes the nodes' rows of each step together: the nodes bit-equal, the
    weights after step 1 and the step losses at the f32 tier, K1's count the
    oracle's (none on the CPU)."""
    trainsize, valsize = 640, 100
    rng = np.random.RandomState(6)
    data = rng.rand(trainsize + valsize, 1, 28, 28).astype(np.float32)
    labels = rng.randint(0, 10, size=trainsize + valsize).astype(np.int32)

    runGrid(gridslice.mnistNode, 2, data, labels, trainsize, valsize, tmp_path, time.time(), timeout=TIMEOUT)
    nodes = gridslice.load(tmp_path, "mnist", 2)
    _bitEqual(nodes, [key for key in nodes[0] if key.startswith("final/") or key == "history"])

    final, steps = gridslice.oracle(data, labels, 2, trainsize)
    assert len(steps.losses) == len(nodes[0]["losses"]) == 5
    for key, value in steps.first.items():
        _close(nodes[0]["first/" + key], value)
    for key, value in final.items():
        _close(nodes[0]["final/" + key], value)

    _close((nodes[0]["losses"] + nodes[1]["losses"]) / 2, steps.losses)
    assert list(nodes[0]["launches"]) == list(steps.launches)


def testGridSliceMeshNode(tmp_path):
    """[grid]'s part (b) on the CPU: a one-rank mesh step is bit-equal to the
    step over no mesh (the one-rank mean is exact)."""
    rng = np.random.RandomState(7)
    data = rng.rand(3 * 128, 1, 28, 28).astype(np.float32)
    labels = rng.randint(0, 10, size=3 * 128).astype(np.int32)

    runGrid(gridslice.meshNode, 1, data, labels, 3, tmp_path, timeout=TIMEOUT)
    got = gridslice.load(tmp_path, "mesh", 1)[0]

    for name in [key[len("single/"):] for key in got if key.startswith("single/")]:
        assert np.array_equal(got["mesh/" + name], got["single/" + name]), name
