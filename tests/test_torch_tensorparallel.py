"""``FusedStep(stateShardings=...)`` with ``tensorParallelSpecs`` and
``zeroOptimizerSpecs`` (``puzzlelib_tpu_torch/fused.py``) against the JAX
package.

Twins of ``tests/test_parallel.py``'s ``testFusedTensorParallelMatchesSingle``
on a (data 2, model 2) mesh, with a conv net beside its MLP so that both
branches of the rules shard, and of ``testFusedZeroOptimizerSharding`` on a
data axis of 4.  The port's ranks are the four nodes of a ``runGrid`` on the
CPU (``mpnodes.py``), which must give the same bits; the JAX package runs
GSPMD over four of its 8 virtual CPU devices.  Two cases place a
tensor-parallel variable's optimizer slots otherwise than the variable (a
plain and a transposed Linear of one square shape under the JAX package's
rule, and the MLP's specs with every slot replicated), where GSPMD gives the
single-device numbers all the same.  The weights after 3 steps are
held to the JAX package's mesh step and to the port's step over no mesh at
f32's 1e-5 (of max(1, max |want|)), and the spec lists to the JAX package's
``PartitionSpec`` lists, placement by placement.  Each fixture runs one
grid."""

import numpy as np
import pytest

import mpnodes


BOUND = 1e-5
RANKS = 4


def _jax():
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


def _inputs():
    rng12, rng9 = np.random.RandomState(12), np.random.RandomState(9)
    inputs = {"mlp/x": rng12.randn(8, 16).astype(np.float32)}
    inputs["mlp/t"] = rng12.randn(8, 8).astype(np.float32)
    inputs["conv/x"] = rng9.randn(8, 3, 8, 8).astype(np.float32)
    inputs["conv/t"] = rng9.randn(8, 4).astype(np.float32)
    rng13 = np.random.RandomState(13)
    inputs["square/x"] = rng13.randn(8, 16).astype(np.float32)
    inputs["square/t"] = rng13.randn(8, 16).astype(np.float32)
    inputs["replicated/x"], inputs["replicated/t"] = inputs["mlp/x"], inputs["mlp/t"]
    return inputs


@pytest.fixture(scope="module")
def tensorParallel(tmp_path_factory):
    inputs = _inputs()
    return inputs, mpnodes.runOnCpu(mpnodes.tensorParallel, RANKS, "tp", tmp_path_factory.mktemp("tp"), inputs)


@pytest.fixture(scope="module")
def zero(tmp_path_factory):
    rng = np.random.RandomState(18)
    inputs = {"x": rng.randn(2 * RANKS, 8).astype(np.float32), "t": rng.randn(2 * RANKS, 4).astype(np.float32)}
    return inputs, mpnodes.runOnCpu(mpnodes.zeroSharded, RANKS, "zero", tmp_path_factory.mktemp("zero"), inputs)


def _encode(shardings, axes):
    """The JAX package's NamedShardings as ``mpnodes.encode`` lists them:
    for each buffer and mesh axis, the dim its spec names the axis on, or
    -1."""
    rows = []
    for sharding in shardings:
        spec = tuple(sharding.spec)
        rows.append([next((dim for dim, name in enumerate(spec) if name == axis), -1) for axis in axes])

    return np.array(rows, dtype=np.int64)


def _jaxSteps(build, optimizer, data, target, mesh=None, specs=None):
    """The JAX package's weights after 3 ``FusedStep`` calls, in
    ``collectParamBuffers`` order, and the shardings used."""
    _, _, M, C, JCost, _, jfused = _jax()
    net = build(M, C)
    optimizer.setupOn(net, useGlobalState=False)
    cost = JCost.MSE()

    shardings = None if specs is None else specs(net, cost, optimizer)
    step = jfused.FusedStep(net, cost, optimizer, mesh=mesh, stateShardings=shardings)
    for _ in range(3):
        step(data, target)

    return [np.asarray(buf.get(), np.float32) for buf in jfused.collectParamBuffers(net)], shardings


@pytest.mark.parametrize("net", ["mlp", "conv"])
def testFusedTensorParallelTwin(tensorParallel, net):
    """3 ``MomentumSGD(0.05, 0.9)`` steps of 8 rows through ``FusedStep`` with
    ``tensorParallelSpecs`` over (data 2, model 2): the weights equal the
    JAX package's tensor-parallel mesh step and the port's step over no
    mesh."""
    jax, Mesh, _, _, _, JOpt, jfused = _jax()
    inputs, got = tensorParallel
    mesh = Mesh(np.array(jax.devices()[:RANKS]).reshape(2, 2), axis_names=("data", "model"))
    build = {"mlp": mpnodes.tpNet, "conv": mpnodes.convNet}[net]
    data, target = inputs[net + "/x"], inputs[net + "/t"]

    want, _ = _jaxSteps(build, JOpt.MomentumSGD(learnRate=0.05, momRate=0.9), data, target, mesh,
                        lambda n, c, o: jfused.tensorParallelSpecs(n, c, o, mesh, modelAxis="model"))
    for index, value in enumerate(want):
        _close(got["%s/mesh/%d" % (net, index)], value)
        _close(got["%s/mesh/%d" % (net, index)], got["%s/single/%d" % (net, index)])


def _replicateSlots(shardings, net, cost, optimizer, mesh):
    """``mpnodes.replicateSlots`` on the JAX package's list."""
    from jax.sharding import NamedSharding, PartitionSpec
    from puzzlelib_tpu.variable import Variable as JVariable

    _, _, _, _, _, _, jfused = _jax()
    _, meta = jfused.collectStateBuffers(net, cost, optimizer, withMeta=True)
    return [NamedSharding(mesh, PartitionSpec()) if isinstance(owner, JVariable) else sharding
            for sharding, (owner, _) in zip(shardings, meta)]


@pytest.mark.parametrize("net,wholeGrads", [("square", 1), ("replicated", 4)])
def testFusedTensorParallelSlotsPlacedOtherwiseTwin(tensorParallel, net, wholeGrads):
    """A tensor-parallel variable whose optimizer slots are not placed as
    the variable (the square net's first W, whose slots the shape rule
    places as the transposed W; every variable of the MLP with its slots
    replicated): the step gathers those gradients whole before the update,
    and the weights after 3 ``MomentumSGD`` steps equal the JAX package's
    mesh step with the same specs and the port's step over no mesh."""
    jax, Mesh, _, _, _, JOpt, jfused = _jax()
    inputs, got = tensorParallel
    mesh = Mesh(np.array(jax.devices()[:RANKS]).reshape(2, 2), axis_names=("data", "model"))
    build = {"square": mpnodes.squareNet, "replicated": mpnodes.tpNet}[net]

    def specs(n, c, o):
        placed = jfused.tensorParallelSpecs(n, c, o, mesh, modelAxis="model")
        return placed if net == "square" else _replicateSlots(placed, n, c, o, mesh)

    want, shardings = _jaxSteps(build, JOpt.MomentumSGD(learnRate=0.05, momRate=0.9), inputs[net + "/x"],
                                inputs[net + "/t"], mesh, specs)
    assert np.array_equal(got[net + "/specs"], _encode(shardings, ("data", "model")))
    assert int(got[net + "/wholeGrads"]) == wholeGrads

    for index, value in enumerate(want):
        _close(got["%s/mesh/%d" % (net, index)], value)
        _close(got["%s/mesh/%d" % (net, index)], got["%s/single/%d" % (net, index)])


@pytest.mark.parametrize("net", ["mlp", "conv"])
def testTensorParallelSpecsTwin(tensorParallel, net):
    """The spec list of each net, placement by placement, is the JAX
    package's: Linear W on its output features, b on dim 0, the conv's W on
    its output maps and b on dim 1, the optimizer slots as the variable of
    their shape, the rest replicated."""
    jax, Mesh, M, C, JCost, JOpt, jfused = _jax()
    _, got = tensorParallel
    mesh = Mesh(np.array(jax.devices()[:RANKS]).reshape(2, 2), axis_names=("data", "model"))

    jnet = {"mlp": mpnodes.tpNet, "conv": mpnodes.convNet}[net](M, C)
    optimizer = JOpt.MomentumSGD(learnRate=0.05, momRate=0.9)
    optimizer.setupOn(jnet, useGlobalState=False)
    want = _encode(jfused.tensorParallelSpecs(jnet, JCost.MSE(), optimizer, mesh, modelAxis="model"),
                   ("data", "model"))

    assert np.array_equal(got[net + "/specs"], want)
    assert (want[:, 1] >= 0).sum() >= 4 and (want[:, 0] == -1).all()


def testFusedZeroOptimizerShardingTwin(zero):
    """``testFusedZeroOptimizerSharding`` on a data axis of 4: each rank's
    Adam slots hold a quarter of their variable's elements, and the weights
    after 3 steps equal the JAX package's ZeRO mesh step and the port's
    step over no mesh."""
    jax, Mesh, _, _, _, JOpt, jfused = _jax()
    inputs, got = zero
    mesh = Mesh(np.array(jax.devices()[:RANKS]), axis_names=("data", ))

    slots = got["slots"]
    assert len(slots) == 8 and (slots[:, 0] * RANKS == slots[:, 1]).all()

    want, _ = _jaxSteps(lambda M, C: mpnodes.zeroNet(RANKS, M, C), JOpt.Adam(alpha=0.01), inputs["x"], inputs["t"],
                        mesh, lambda n, c, o: jfused.zeroOptimizerSpecs(n, c, o, mesh, dataAxis="data"))
    for index, value in enumerate(want):
        _close(got["mesh/%d" % index], value)
        _close(got["mesh/%d" % index], got["single/%d" % index])


def testCutSlotsBelongToTheirStep(zero):
    """Once the ZeRO step has cut the Adam slots to this rank's block, a
    second step's specs over them, the optimizer's own update and its save
    raise ``ValueError``, rather than cut them again or update and save
    blocks as whole slots."""
    _, got = zero
    secondStep, update, save = (str(message) for message in got["refusals"])
    assert "another FusedStep's stateShardings cut them" in secondStep
    assert "hold one rank's block" in update and "hold one rank's block" in save


@pytest.mark.parametrize("net", ["mlp", "conv"])
def testZeroOptimizerSpecsTwin(zero, net):
    """The ZeRO spec list of each net, placement by placement, is the JAX
    package's: every optimizer slot on its first dim that divides over the
    data axis (and is at least its size), the parameters, gradients and
    the rest replicated."""
    jax, Mesh, M, C, JCost, JOpt, jfused = _jax()
    _, got = zero
    mesh = Mesh(np.array(jax.devices()[:RANKS]), axis_names=("data", ))

    jnet = {"mlp": lambda: mpnodes.zeroNet(RANKS, M, C), "conv": lambda: mpnodes.convNet(M, C)}[net]()
    optimizer = JOpt.Adam(alpha=0.01)
    optimizer.setupOn(jnet, useGlobalState=False)
    want = _encode(jfused.zeroOptimizerSpecs(jnet, JCost.MSE(), optimizer, mesh, dataAxis="data"), ("data", ))

    assert np.array_equal(got["specs" if net == "mlp" else "conv/specs"], want)
    assert (want >= 0).sum() >= 4
