"""Expert parallelism (``puzzlelib_tpu_torch/parallel/moe.py`` ``moeForward``,
``SwitchMoE.distributedForward``) against the JAX package.

Twins of ``tests/test_moe.py``'s three tests and of
``tests/test_moe_module.py``'s ``testSwitchMoEDistributedMatchesEager``.
The port's ranks are the four nodes of a ``runGrid`` on the CPU, each with a
``DeviceMesh`` of one "expert" axis, one expert a rank (``mpnodes.py``);
the JAX package runs on four of its 8 virtual CPU devices.  The ranks must
give the same bits (their outputs and gradients are whole), and the port
must be within f32's 1e-5 (of max(1, max |want|)) of the JAX package.  The
module runs one grid, which every test of it reads."""

import numpy as np
import pytest

import mpnodes


BOUND = 1e-5
EXPERTS = 4
DIM = 8


def _jax():
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    return jax, jnp, Mesh(np.array(jax.devices()[:EXPERTS]), ("expert", ))


def _close(got, want, bound=BOUND):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def _params(seed):
    """``tests/test_moe.py``'s ``makeParams``, stacked, as numpy."""
    rng = np.random.RandomState(seed)
    params = [{"w": rng.randn(DIM, 16).astype(np.float32) * 0.3, "w2": rng.randn(16, DIM).astype(np.float32) * 0.3}
              for _ in range(EXPERTS)]
    return {key: np.stack([p[key] for p in params]) for key in ("w", "w2")}


def _inputs():
    rng0, rng2, rng22 = np.random.RandomState(0), np.random.RandomState(2), np.random.RandomState(22)
    inputs = {"oracle": _params(1), "oracleGate": rng0.randn(DIM, EXPERTS).astype(np.float32), "train": _params(3)}
    inputs["oracleX"] = rng0.randn(32, DIM).astype(np.float32)
    inputs["trainGate"] = (rng2.randn(DIM, EXPERTS).astype(np.float32) * 0.1)
    inputs["trainX"] = rng2.randn(32, DIM).astype(np.float32)
    inputs["trainT"] = np.tanh(rng2.randn(32, DIM)).astype(np.float32)
    inputs["moduleGate"] = rng22.randn(DIM, EXPERTS).astype(np.float32)
    inputs["moduleX"] = rng22.randn(4 * EXPERTS, DIM).astype(np.float32)
    inputs["layerX"] = np.random.RandomState(3).randn(16, DIM).astype(np.float32)
    return inputs


@pytest.fixture(scope="module")
def experts(tmp_path_factory):
    inputs = _inputs()
    return inputs, mpnodes.runOnCpu(mpnodes.expertParallel, EXPERTS, "expert", tmp_path_factory.mktemp("expert"),
                                    inputs)


def _expertFn(params, tokens):
    import jax
    return jax.nn.relu(tokens @ params["w"]) @ params["w2"]


def testMoEMatchesOracleTwin(experts):
    """``testMoEMatchesOracle``: the output equals the JAX package's
    ``moeForward`` and the dense per-token routing (capacity 10 of 32
    tokens over 4 experts at 1.25); the auxiliary loss equals the JAX
    package's and is positive."""
    jax, jnp, mesh = _jax()
    from puzzlelib_tpu.parallel.moe import moeForward

    inputs, got = experts
    gateW, x = inputs["oracleGate"], inputs["oracleX"]
    out, aux = moeForward(_expertFn, jax.tree.map(jnp.asarray, inputs["oracle"]), jnp.asarray(gateW), jnp.asarray(x),
                          mesh, "expert", capacityFactor=1.25)

    _close(got["oracle/out"], out)
    _close(got["oracle/aux"], aux)
    assert float(got["oracle/aux"]) > 0.0

    logits = x @ gateW
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    counts, ref = [0] * EXPERTS, np.zeros_like(x)
    for i, e in enumerate(probs.argmax(axis=1)):
        if counts[e] < int(np.ceil(1.25 * 32 / EXPERTS)):
            counts[e] += 1
            ref[i] = probs[i, e] * (np.maximum(x[i] @ inputs["oracle"]["w"][e], 0.0) @ inputs["oracle"]["w2"][e])

    _close(got["oracle/out"], ref)


def testMoETrainsTwin(experts):
    """``testMoETrains``: the gradients of ``mean((out - target)^2) + 0.01 *
    auxLoss`` at the first step, on every rank, equal ``jax.grad`` of the
    JAX package's ``moeForward`` (the stacked expert parameters and the
    gate), and 25 steps of 0.3 cut the loss below 0.8 of the first."""
    jax, jnp, mesh = _jax()
    from puzzlelib_tpu.parallel.moe import moeForward

    inputs, got = experts
    x, target = jnp.asarray(inputs["trainX"]), jnp.asarray(inputs["trainT"])

    def loss(params, gw):
        out, aux = moeForward(_expertFn, params, gw, x, mesh, "expert")
        return jnp.mean((out - target) ** 2) + 0.01 * aux

    _, (gParams, gGate) = jax.value_and_grad(loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, inputs["train"]),
                                                                  jnp.asarray(inputs["trainGate"]))
    _close(got["train/w"], gParams["w"])
    _close(got["train/w2"], gParams["w2"])
    _close(got["train/gate"], gGate)

    losses = got["train/losses"]
    assert losses[-1] < losses[0] * 0.8, losses


def testMoEModuleExpertsTwin(experts):
    """``testMoEModuleExperts``: Module experts (``functionalize``'s apply)
    route as the same weights in torch operations, and as the JAX
    package's Module experts."""
    jax, jnp, mesh = _jax()
    from puzzlelib_tpu.containers import Sequential
    from puzzlelib_tpu.fused import collectParamBuffers, functionalize
    from puzzlelib_tpu.modules import Activation, Linear, relu
    from puzzlelib_tpu.parallel.moe import moeForward, stackExpertParams

    inputs, got = experts
    np.random.seed(21)

    def makeExpert():
        expert = Sequential()
        expert.append(Linear(DIM, 16, wscale=0.3, initscheme="gaussian"))
        expert.append(Activation(relu))
        expert.append(Linear(16, DIM, wscale=0.3, initscheme="gaussian"))
        return expert

    stacked = stackExpertParams([[buf.jax for buf in collectParamBuffers(makeExpert())] for _ in range(EXPERTS)])
    apply, _ = functionalize(makeExpert())
    out, aux = moeForward(apply, stacked, jnp.asarray(inputs["moduleGate"]), jnp.asarray(inputs["moduleX"]), mesh,
                          "expert")

    _close(got["module/out"], got["module/raw"])
    _close(got["module/aux"], got["module/rawAux"])
    _close(got["module/out"], out)
    _close(got["module/aux"], aux)


def testSwitchMoEDistributedMatchesEagerTwin(experts):
    """``testSwitchMoEDistributedMatchesEager``, under global state (where
    the experts' variables are views of one flat buffer): one expert a rank,
    the output and the auxiliary loss equal the eager layer's, and the JAX
    package's eager layer's."""
    _jax()
    from puzzlelib_tpu import containers as JC
    from puzzlelib_tpu import modules as J
    from puzzlelib_tpu.backend import gpuarray

    inputs, got = experts
    _close(got["layer/out"], got["layer/eager"])
    assert np.array_equal(got["layer/aux"], got["layer/eagerAux"])

    layer = mpnodes.switchMoE(J, JC)
    _close(got["layer/out"], layer(gpuarray.to_gpu(inputs["layerX"])).get())
    _close(got["layer/aux"], layer.auxLoss.get())


def testMoEGateWidthTwin(experts):
    """A gate whose width is not the expert count raises the JAX package's
    message, before any collective."""
    _, got = experts
    assert "Gate width %d does not match expert count %d" % (EXPERTS + 1, EXPERTS) in str(got["message"])
