"""The RBM against the JAX package: twins of ``tests/test_rbm.py``, and the
slice's script ``tools/rbmslice.py``.

The JAX package draws its units from ``jax.random`` keys, the port from its
``rng`` facade (``fillUniform``).  The twins give both the same uniforms:
the JAX RBM takes keys from a seeded stream (``KeyStream``) and the port's
RBM takes, through ``JaxUniforms``, the uniforms the JAX package draws
from the same keys, in the same order.  f32 is held within 1e-5 of max(1,
max |ref|), the reference's f32 tier."""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch.convert import paramsFromNumpy, paramsToNumpy
from puzzlelib_tpu_torch.models.misc import RBM
from puzzlelib_tpu_torch.optimizers import MomentumSGD as TMomentumSGD
from puzzlelib_tpu_torch.tools import rbmslice


BOUND = 1e-5


def _jax():
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    import jax
    from puzzlelib_tpu.backend import gpuarray
    from puzzlelib_tpu.models.misc.rbm import RBM as JRBM
    from puzzlelib_tpu.optimizers import MomentumSGD

    return jax, gpuarray, JRBM, MomentumSGD


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _close(got, want, bound=BOUND):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, dtype=np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


class KeyStream:
    """The JAX RBM's ``rng``: a key a call, split off a seeded key."""

    def __init__(self, seed):
        import jax
        self.key = jax.random.key(seed)

    def nextKey(self):
        import jax
        self.key, sub = jax.random.split(self.key)
        return sub


class JaxUniforms:
    """The port RBM's ``rng``: ``fillUniform`` writes the uniforms that the
    JAX package draws from ``KeyStream(seed)``'s keys: a Gibbs step splits
    its key in three, one a draw; a sampler call draws from its key."""

    def __init__(self, seed, perKey):
        self.keys, self.perKey, self.pending = KeyStream(seed), perKey, []

    def fillUniform(self, data, minval=0.0, maxval=1.0):
        import jax

        if not self.pending:
            key = self.keys.nextKey()
            self.pending = list(jax.random.split(key, self.perKey)) if self.perKey > 1 else [key]

        draws = jax.random.uniform(self.pending.pop(0), tuple(data.shape), dtype=np.float32)
        data.copy_(torch.from_numpy(np.array(draws)))


def _twins(vsize, hsize, seed, perKey=3, **kwargs):
    _, _, JRBM, _ = _jax()
    np.random.seed(seed)
    jrbm = JRBM(vsize, hsize, rng=KeyStream(seed), **kwargs)
    np.random.seed(seed)
    trbm = RBM(vsize, hsize, rng=JaxUniforms(seed, perKey), **kwargs)
    return jrbm, trbm


def testRBMGradOracleTwin():
    """``testRBMGradOracle``: every pre-activation saturated, so the units
    are the signs' whatever the draws; the port's CD-1 gradients are the
    numpy oracle's exactly, and the JAX package's."""
    _, gpuarray, JRBM, _ = _jax()
    vsize, hsize, batch = 6, 4, 5

    rbm, jrbm = RBM(vsize, hsize), JRBM(vsize, hsize)
    np.random.seed(54)
    sign = lambda shape: np.random.choice([-1.0, 1.0], size=shape)
    W = (sign((vsize, hsize)) * np.random.uniform(30, 50, (vsize, hsize))).astype(np.float32)
    b = (sign(vsize) * np.random.uniform(30, 50, vsize)).astype(np.float32)
    c = (sign(hsize) * np.random.uniform(30, 50, hsize)).astype(np.float32)
    data = np.random.binomial(1, 0.5, size=(batch, vsize)).astype(np.float32)

    paramsFromNumpy(rbm, {"W": W, "b": b, "c": c})
    for name, ary in (("W", W), ("b", b), ("c", c)):
        jrbm.vars[name].data.set(ary)

    hData, vModel, hModel = rbm.calcCDGrad(torch.from_numpy(data))
    jrbm.calcCDGrad(gpuarray.to_gpu(data))

    wantH = (data @ W + c > 0).astype(np.float32)
    wantV = (wantH @ W.T + b > 0).astype(np.float32)
    wantM = (wantV @ W + c > 0).astype(np.float32)
    for pre in (data @ W + c, wantH @ W.T + b, wantV @ W + c):
        assert np.min(np.abs(pre)) > 15.0

    assert np.array_equal(hData.numpy(), wantH) and np.array_equal(vModel.numpy(), wantV)
    assert np.array_equal(hModel.numpy(), wantM)
    oracle = {"W": data.T @ wantH - wantV.T @ wantM, "b": data.sum(0) - wantV.sum(0), "c": wantH.sum(0) - wantM.sum(0)}
    for name, want in oracle.items():
        assert np.array_equal(rbm.vars[name].grad.numpy(), want), name
        assert np.array_equal(jrbm.vars[name].grad.get(), want), name


@pytest.mark.parametrize("persistent", [False, True])
def testRBMLearnsTwin(persistent):
    """``testRBMLearns`` on the JAX package's draws: 120 CD-1 (or PCD) steps
    of ``MomentumSGD(0.02 / 64, 0.9)`` on the test's two prototypes, every
    step's gradients and the final weights the JAX package's, the
    reconstruction error below half (PCD: 0.7) of its start, and the
    particles of the batch's shape."""
    _, gpuarray, _, JMomentumSGD = _jax()
    np.random.seed(4)
    vsize, hsize, batch = 12, 8, 64

    protos = np.zeros((2, vsize), dtype=np.float32)
    protos[0, :vsize // 2] = 1.0
    protos[1, vsize // 2:] = 1.0
    data = protos[np.random.randint(0, 2, size=batch)]

    def reconErr(W, b, c):
        probs = sigmoid(sigmoid(data @ W + c) @ W.T + b)
        return float(np.mean((probs - data) ** 2))

    jrbm, trbm = _twins(vsize, hsize, 11, wscale=0.5)
    jopt, topt = JMomentumSGD(learnRate=0.02 / batch, momRate=0.9), TMomentumSGD(learnRate=0.02 / batch, momRate=0.9)
    jopt.setupOn(jrbm)
    topt.setupOn(trbm)
    before = reconErr(*(v.data.numpy() for v in trbm.vars.values()))

    jdata, tdata = gpuarray.to_gpu(data), torch.from_numpy(data)
    for _ in range(120):
        np.random.seed(7)
        (jrbm.calcPCDGrad if persistent else jrbm.calcCDGrad)(jdata)
        np.random.seed(7)
        (trbm.calcPCDGrad if persistent else trbm.calcCDGrad)(tdata)

        for name, var in jrbm.vars.items():
            _close(trbm.vars[name].grad, var.grad.get())
        jopt.update()
        topt.update()

    weights = paramsToNumpy(trbm)
    for name, var in jrbm.vars.items():
        _close(weights[name], var.data.get())

    after = reconErr(weights["W"], weights["b"], weights["c"])
    assert after < before * (0.7 if persistent else 0.5), (before, after)
    if persistent:
        assert tuple(trbm.particles.shape) == (batch, hsize)
        assert np.array_equal(trbm.particles.numpy(), jrbm.particles.get())


def testRBMSamplersTwin():
    """``testRBMSamplers``: binary units of the right shapes, without
    biases, and the JAX package's units on its draws."""
    _, gpuarray, _, _ = _jax()
    jrbm, trbm = _twins(7, 3, 5, perKey=1, useBias=False)
    assert sorted(trbm.vars) == ["W"]

    v = np.random.RandomState(5).binomial(1, 0.5, size=(4, 7)).astype(np.float32)
    h = trbm.hiddenFromVisible(torch.from_numpy(v))
    jh = jrbm.hiddenFromVisible(gpuarray.to_gpu(v))
    assert tuple(h.shape) == (4, 3) and set(np.unique(h.numpy())) <= {0.0, 1.0}
    assert np.array_equal(h.numpy(), jh.get())

    v2 = trbm.visibleFromHidden(h)
    jv2 = jrbm.visibleFromHidden(jh)
    assert tuple(v2.shape) == (4, 7) and set(np.unique(v2.numpy())) <= {0.0, 1.0}
    assert np.array_equal(v2.numpy(), jv2.get())


def testRBMTableAndProtocol():
    """The JAX RBM's W, b and c load by name; the module protocol refuses a
    call, as the reference RBM does."""
    jrbm, trbm = _twins(6, 4, 3)
    table = {name: var.data.get() + 0.25 for name, var in jrbm.vars.items()}
    paramsFromNumpy(trbm, table)
    assert sorted(paramsToNumpy(trbm)) == ["W", "b", "c"]
    assert all(np.array_equal(paramsToNumpy(trbm)[n], table[n]) for n in table)

    with pytest.raises(RuntimeError, match="full module interface"):
        trbm(torch.zeros(2, 6))


def testRBMSliceOnCpu():
    """The slice at a narrow width: the reconstruction error falls under
    CD-1 and PCD, a second run gives the same bits, and the CD-1 gradient is
    an f64 numpy step on the units the draws give."""
    rows = torch.from_numpy(rbmslice.data(32, vsize=40, prototypes=4))
    for persistent in (False, True):
        errors = []
        rbm = rbmslice.train(rows, persistent, steps=10, errors=errors)
        again = rbmslice.train(rows, persistent, steps=10)
        assert errors[-1] < errors[0]
        assert all(torch.equal(a.data, b.data) for a, b in zip(rbm.vars.values(), again.vars.values()))

    rbm = rbmslice.build(40, 16)
    hData, vModel, hModel = rbm.calcCDGrad(rows)
    x = rows.double().numpy()
    gW = x.T @ hData.double().numpy() - vModel.double().numpy().T @ hModel.double().numpy()
    _close(rbm.vars["W"].grad, gW)
