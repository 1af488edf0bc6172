"""Sequence parallelism (``puzzlelib_tpu_torch/parallel/seqparallel.py``)
against the JAX package: twins of ``tests/test_seqparallel.py``'s three
tests, on a model axis of 4 on both sides (the JAX package's first test
runs on 8 devices; 4 keep the port's grid small).  The port's ranks are the
four nodes of a ``runGrid`` on the CPU (``mpnodes.py``), which must give
the same bits; the output and the gradients of every rank are held to
f32's 1e-5 (of max(1, max |want|)).  The module runs one grid."""

import numpy as np
import pytest

import mpnodes


BOUND = 1e-5
SHARDS = 4


def _jax():
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    return jax, jnp, Mesh(np.array(jax.devices()[:SHARDS]), ("model", ))


def _close(got, want, bound=BOUND):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def _inputs():
    rng0, rng1 = np.random.RandomState(0), np.random.RandomState(1)
    inputs = {"dense/x": rng0.randn(32, 16).astype(np.float32)}
    inputs["dense/w1"] = rng0.randn(16, 64).astype(np.float32) * 0.2
    inputs["dense/w2"] = rng0.randn(64, 16).astype(np.float32) * 0.2
    inputs["grad/x"] = rng1.randn(16, 8).astype(np.float32)
    inputs["grad/w1"] = rng1.randn(8, 32).astype(np.float32) * 0.3
    inputs["grad/w2"] = rng1.randn(32, 8).astype(np.float32) * 0.3
    inputs["grad/t"] = rng1.randn(16, 8).astype(np.float32)
    return inputs


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    inputs = _inputs()
    return inputs, mpnodes.runOnCpu(mpnodes.seqParallel, SHARDS, "seq", tmp_path_factory.mktemp("seq"), inputs)


def testSeqParallelMLPMatchesDenseTwin(shards):
    """``testSeqParallelMLPMatchesDense``: the whole output equals the JAX
    package's ``seqParallelMLP`` and the dense ``gelu(x @ w1) @ w2``
    (``jax.nn.gelu``'s tanh form)."""
    jax, jnp, mesh = _jax()
    from puzzlelib_tpu.parallel.seqparallel import seqParallelMLP

    inputs, got = shards
    x, w1, w2 = (jnp.asarray(inputs["dense/" + key]) for key in ("x", "w1", "w2"))

    _close(got["dense"], seqParallelMLP(x, w1, w2, mesh, axis="model"))
    _close(got["dense"], jax.nn.gelu(x @ w1) @ w2)


def testSeqParallelGradTwin(shards):
    """``testSeqParallelGrad``: the gradients of a mean-square loss of the
    output, on every rank, equal ``jax.grad`` of the JAX package's
    ``seqParallelMLP`` and of the dense MLP."""
    jax, jnp, mesh = _jax()
    from puzzlelib_tpu.parallel.seqparallel import seqParallelMLP

    inputs, got = shards
    x, w1, w2, t = (jnp.asarray(inputs["grad/" + key]) for key in ("x", "w1", "w2", "t"))

    def lossSp(a, b):
        return jnp.mean((seqParallelMLP(x, a, b, mesh) - t) ** 2)

    def lossRef(a, b):
        return jnp.mean((jax.nn.gelu(x @ a) @ b - t) ** 2)

    for fn in (lossSp, lossRef):
        g1, g2 = jax.grad(fn, argnums=(0, 1))(w1, w2)
        _close(got["grad/w1"], g1)
        _close(got["grad/w2"], g2)


def testSeqParallelValidationTwin(shards):
    """``testSeqParallelValidation``: a token dim or a hidden dim that does
    not divide over the axis raises the JAX package's message."""
    _, got = shards
    tokens, hidden = (str(text) for text in got["messages"])

    assert "Token dim 10 not divisible by 4 'model' shards" in tokens
    assert "Hidden dim 30 not divisible by 4 'model' shards" in hidden
