"""``puzzlelib_tpu_torch/testlib/ctctrain.py`` against the root script:
``makeBatch`` bit-equal under one generator, the reduced Wave2Letter built
in both packages from the script's seed (the same weights, checked), and
two training steps of the script's loop (forward, ``moveaxis`` to (T, B,
V), ``CTC(blank=0, vocabsize=29)``, the gradient moved back, backward,
``Adam(1e-3)`` in local state): the NLLs and the weights within 1e-5 of
max(1, max |ref|), the f32 tier.  The biases of the three convs that a
batch norm follows (``c1_conv.b`` to ``c3_conv.b``) have an exact gradient
of zero (the norm takes out the mean), so Adam moves them on round-off by
up to alpha a step in either direction: they are held to 2 * alpha * steps,
as ``tests/test_torch_fused.py`` holds the attention's key biases.  An
entry of another weight whose gradient lies near Adam's epsilon parts
further: Adam's step alpha * m / (sqrt(v) + epsilon), bias-corrected, has a
slope of up to alpha / epsilon' (3162 * alpha at the first step) there.
So each step's gap in a weight is held to what Adam's update makes of the
two packages' gradients from the port's moments before the step (in f64),
summed over the steps, on top of the f32 tier; the first step's gradients
themselves within the f32 tier of their own scale."""

import importlib

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch.convert import paramsToNumpy
from puzzlelib_tpu_torch.testlib import ctctrain as TCtc


BOUND = 1e-5
ALPHA = 1e-3
NORMED_BIASES = ("c1_conv.b", "c2_conv.b", "c3_conv.b")


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    monkeypatch.setattr(TConfig, "device", "cpu")


def _jax():
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    return importlib.import_module("testlib.ctctrain")


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(want).all()
    assert np.abs(got - want).max() <= BOUND * max(1.0, np.abs(want).max())


def testMakeBatchBitEqual():
    """Three batches from ``RandomState(7)`` and the script's embedding:
    frames (16, 13, 48) f32, 192 labels in [1, 29), lengths of 12."""
    JCtc = _jax()
    for script in (JCtc, TCtc):
        assert (script.VOCAB, script.BLANK, script.FEATS, script.LABLEN, script.STRETCH, script.BATCH) == \
            (29, 0, 13, 12, 4, 16)

    rngs = [np.random.RandomState(7), np.random.RandomState(7)]
    embeds = [rng.randn(TCtc.VOCAB, TCtc.FEATS).astype(np.float32) for rng in rngs]
    for _ in range(3):
        want, got = JCtc.makeBatch(rngs[0], embeds[0]), TCtc.makeBatch(rngs[1], embeds[1])
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)

    assert got[0].shape == (16, 13, 48) and got[1].min() >= 1 and got[1].max() < 29


def _grads(net, host):
    """Each variable's gradient of the last backward, by name."""
    return {name: np.asarray(host(var.grad), np.float64) for var, names in net.getVarTable().items()
            for name in names}


def _adamGaps(states, tgrads, jgrads, t, beta1=0.9, beta2=0.999, epsilon=1e-8):
    """|Adam's update on the port's gradient - on the JAX package's| of
    step ``t``, entry by entry in f64, from the port's moments (mg, ms)
    before the step."""
    lr = ALPHA * np.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)

    def update(g, mg, ms):
        m, v = mg + (1.0 - beta1) * (g - mg), ms + (1.0 - beta2) * (g * g - ms)
        return lr * m / (np.sqrt(v) + epsilon)

    return {name: np.abs(update(tgrads[name], *states[name]) - update(jgrads[name], *states[name]))
            for name in jgrads}


def testTrainingStepsTwin():
    """The script's net from ``np.random.seed(7)`` in both packages, then
    two steps of its loop on the script's first two batches: each step's
    NLL and the weights after it; the first step's gradients within the f32
    tier of their own scale."""
    JCtc = _jax()
    from puzzlelib_tpu.backend import gpuarray as jgpu
    from puzzlelib_tpu.backend.memory import moveaxis as jMoveaxis
    from puzzlelib_tpu.cost import CTC as JCTC
    from puzzlelib_tpu.optimizers import Adam as JAdam

    rng = np.random.RandomState(TCtc.SEED)
    embed = rng.randn(TCtc.VOCAB, TCtc.FEATS).astype(np.float32)
    np.random.seed(TCtc.SEED)
    jnet = JCtc.buildNet()
    jopt = JAdam(alpha=1e-3)
    jopt.setupOn(jnet, useGlobalState=False)
    jcost = JCTC(blank=0, vocabsize=29)

    tnet, topt, tcost, trng, tembed = TCtc.buildTraining()
    assert np.array_equal(tembed, embed)

    jtable = {name: np.asarray(var.data.get()) for var, names in jnet.getVarTable().items() for name in names}
    ttable = paramsToNumpy(tnet)
    assert sorted(ttable) == sorted(jtable)
    assert all(np.array_equal(ary, jtable[name]) for name, ary in ttable.items())

    datalen = np.full((TCtc.BATCH, ), TCtc.LABLEN * TCtc.STRETCH // 2, dtype=np.int32)
    gaps = {}
    for steps in (1, 2):
        data, labels, lengths = JCtc.makeBatch(rng, embed)

        out = jnet(jgpu.to_gpu(data))
        jerror, grad = jcost((jMoveaxis(out, 2, 0), jgpu.to_gpu(datalen)),
                             (jgpu.to_gpu(labels), jgpu.to_gpu(lengths)))
        jopt.zeroGradParams()
        jnet.backward(jMoveaxis(grad, 0, 2), updGrad=False)
        jopt.update()
        jnet.reset()

        states = {name: tuple(np.asarray(state[key].numpy(), np.float64) for key in ("mg", "ms"))
                  for name, state in topt.states.items()}
        tdata, tlabels, tlengths = TCtc.makeBatch(trng, tembed)
        assert np.array_equal(tdata, data) and np.array_equal(tlabels, labels)
        terror = TCtc.step(tnet, topt, tcost, tdata, datalen, tlabels, tlengths)
        _close(terror, float(jerror))

        tgrads, jgrads = _grads(tnet, lambda g: g.numpy()), _grads(jnet, lambda g: g.get())
        if steps == 1:
            for name, want in jgrads.items():
                if name not in NORMED_BIASES:
                    assert np.abs(tgrads[name] - want).max() <= BOUND * np.abs(want).max(), name

        for name, gap in _adamGaps(states, tgrads, jgrads, steps).items():
            gaps[name] = gaps.get(name, 0.0) + gap

        jtable = {name: np.asarray(var.data.get()) for var, names in jnet.getVarTable().items() for name in names}
        for name, ary in paramsToNumpy(tnet).items():
            gap, want = np.abs(ary - jtable[name]), jtable[name]
            if name in NORMED_BIASES:
                assert gap.max() <= 2 * ALPHA * steps, name
            else:
                assert (gap <= BOUND * max(1.0, np.abs(want).max()) + gaps[name]).all(), (name, gap.max())
