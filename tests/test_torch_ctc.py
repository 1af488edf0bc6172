"""CTC (``ops/ctc.py``, ``cost/ctc.py``) against the JAX package's
``ctcLoss`` and against ``hostCTCLoss``, the independent f64 numpy oracle:
variable label and time lengths, ``normalized`` probabilities, bf16 scores,
a sample whose labels cannot fit in its time, and brute-force enumeration
of the alignments (the twin of the JAX package's ``testCTCAgainstBruteForce``).

Tolerances: the port's recursions run in f64 and the JAX package's in f32,
so the two agree within 1e-5 of max(1, max |want|) at these lengths, and
the port agrees with the f64 oracle within 1e-5 relative (its softmax is
f32).  The card-only cases (``cuda`` marker) hold the card's result to the
CPU's and require two calls to give the same bits."""

import itertools

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch.cost import CTC as TCTC
from puzzlelib_tpu_torch.cost import CostError
from puzzlelib_tpu_torch.ops import ctc


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card (the card-only
    cases set "cuda" themselves)."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _jaxCtc():
    pytest.importorskip("puzzlelib_tpu.ops.ctc", reason="the twins need the JAX package")
    import jax.numpy as jnp
    from puzzlelib_tpu.ops import ctc as jctc

    return jnp, jctc


def _batch(seed=7, T=11, V=6):
    """The JAX package's host-oracle case: four samples of 4, 3, 2 and 1
    labels (a repeat among them) over 11, 9, 7 and 5 steps."""
    data = np.random.RandomState(seed).randn(T, 4, V).astype(np.float32)
    datalen = np.array([11, 9, 7, 5], np.int32)
    lengths = np.array([4, 3, 2, 1], np.int32)
    labels = np.array([1, 2, 2, 3, 4, 1, 5, 2, 3, 5], np.int32)
    return data, datalen, labels, lengths


def _closeGrad(got, want, bound=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("blank", [0, 5])
def testCtcTwinAndHostOracle(blank):
    """Variable lengths, the blank first or last: the error and the descent
    gradient against the JAX package's and the oracle's (whose gradient is
    the loss's, of the other sign); zero past each sample's datalen."""
    jnp, jctc = _jaxCtc()
    data, datalen, labels, lengths = _batch()
    labels = np.where(labels == blank, 0 if blank else 5, labels).astype(np.int32)

    err, grad = ctc.ctcLoss(torch.from_numpy(data), datalen, labels, lengths, blank)
    jerr, jgrad = jctc.ctcLoss(jnp.asarray(data), datalen, labels, lengths, blank)
    hostErr, hostGrad, _ = ctc.hostCTCLoss(data, datalen, labels, lengths, blank)

    assert err.dtype == grad.dtype == torch.float32 and err.dim() == 0
    assert err.item() == pytest.approx(float(jerr), rel=1e-5)
    assert err.item() == pytest.approx(float(hostErr), rel=1e-5)
    _closeGrad(grad.numpy(), np.asarray(jgrad))
    _closeGrad(-grad.numpy(), hostGrad)

    for b, n in enumerate(datalen):
        assert not grad[n:, b].any()


def testCtcNormalizedTwin():
    """Probabilities in, taken as they are: the same error as the scores'
    softmax, and the JAX package's gradient p - posterior."""
    jnp, jctc = _jaxCtc()
    data, datalen, labels, lengths = _batch(seed=3)
    p = np.exp(data) / np.exp(data).sum(axis=2, keepdims=True)

    err, grad = ctc.ctcLoss(torch.from_numpy(p), datalen, labels, lengths, 0, normalized=True)
    jerr, jgrad = jctc.ctcLoss(jnp.asarray(p), datalen, labels, lengths, 0, normalized=True)
    scoreErr, scoreGrad = ctc.ctcLoss(torch.from_numpy(data), datalen, labels, lengths, 0)

    assert err.item() == pytest.approx(float(jerr), rel=1e-5)
    assert err.item() == pytest.approx(scoreErr.item(), rel=1e-5)
    _closeGrad(grad.numpy(), np.asarray(jgrad))
    _closeGrad(grad.numpy(), scoreGrad.numpy())


def testCtcBf16ScoresTwin():
    """bf16 scores: softmaxed in f32, the gradient in f32, the same values
    as the JAX package on the same bf16 scores."""
    jnp, jctc = _jaxCtc()
    import ml_dtypes

    data, datalen, labels, lengths = _batch(seed=4)
    bf16 = data.astype(ml_dtypes.bfloat16)

    err, grad = ctc.ctcLoss(torch.from_numpy(data).bfloat16(), datalen, labels, lengths, 0)
    jerr, jgrad = jctc.ctcLoss(jnp.asarray(bf16), datalen, labels, lengths, 0)

    assert grad.dtype == torch.float32 and np.asarray(jgrad).dtype == np.float32
    assert err.item() == pytest.approx(float(jerr), rel=1e-5)
    _closeGrad(grad.numpy(), np.asarray(jgrad))


def testCtcUnfittableLabelsKeepJaxsValue():
    """A sample of 3 labels over 2 steps cannot align: the JAX package
    clamps its log-likelihood at -1e30, and so does the port (the error
    1e30), where ``torch.nn.functional.ctc_loss`` gives inf; the other
    samples' gradients are the JAX package's, and so is the clamped one's."""
    jnp, jctc = _jaxCtc()
    data, _, _, _ = _batch(seed=5)
    datalen = np.array([11, 9, 7, 2], np.int32)
    lengths = np.array([4, 3, 2, 3], np.int32)
    labels = np.array([1, 2, 2, 3, 4, 1, 5, 2, 3, 5, 4, 5], np.int32)

    err, grad = ctc.ctcLoss(torch.from_numpy(data), datalen, labels, lengths, 0)
    jerr, jgrad = jctc.ctcLoss(jnp.asarray(data), datalen, labels, lengths, 0)

    assert err.item() == float(jerr) and 1e30 <= err.item() < 1.01e30
    _closeGrad(grad.numpy(), np.asarray(jgrad))

    library = torch.nn.functional.ctc_loss(torch.log_softmax(torch.from_numpy(data), 2), torch.from_numpy(labels),
                                           torch.from_numpy(datalen), torch.from_numpy(lengths), reduction="none")
    assert torch.isinf(library[3]) and torch.isfinite(library[:3]).all()


def testCtcAgainstBruteForce():
    """The twin of the JAX package's ``testCTCAgainstBruteForce``: the NLL
    of labels [1, 2] over 4 steps of 3 symbols is -log of the summed
    probability of every path that collapses to them, and the gradient
    matches central differences of the loss."""
    np.random.seed(8)
    T, V, blank = 4, 3, 0
    data = np.random.randn(T, 1, V).astype(np.float32)
    labels, lengths, datalen = np.array([1, 2], np.int32), np.array([2], np.int32), np.array([T], np.int32)

    err, grad = ctc.ctcLoss(torch.from_numpy(data), datalen, labels, lengths, blank)

    p = np.exp(data[:, 0]) / np.exp(data[:, 0]).sum(axis=1, keepdims=True)

    def collapse(path):
        out, prev = [], None
        for s in path:
            if s != prev and s != blank:
                out.append(s)
            prev = s
        return out

    total = sum(np.prod([p[t, s] for t, s in enumerate(path)])
                for path in itertools.product(range(V), repeat=T) if collapse(path) == [1, 2])
    assert err.item() == pytest.approx(-np.log(total), rel=1e-4)

    h = 1e-3
    for idx in [(0, 0, 1), (2, 0, 0), (3, 0, 2)]:
        plus, minus = data.copy(), data.copy()
        plus[idx] += h
        minus[idx] -= h

        fd = (ctc.ctcLoss(torch.from_numpy(plus), datalen, labels, lengths, blank)[0].item() -
              ctc.ctcLoss(torch.from_numpy(minus), datalen, labels, lengths, blank)[0].item()) / (2 * h)
        assert -grad[idx].item() == pytest.approx(fd, abs=1e-2)


def testCtcAtWave2LettersLengthAgainstHost():
    """800 steps, 8 samples of 120 to 240 labels from 29 symbols, as the
    slice's Wave2Letter trains: the port within 1e-5 of the f64 oracle,
    error and gradient (the JAX package's f32 recursions lose some 3e-3 of
    the gradient there)."""
    rng = np.random.RandomState(0)
    T, B, V = 800, 8, 29
    data = rng.randn(T, B, V).astype(np.float32)
    lengths = rng.randint(120, 241, size=B).astype(np.int32)
    labels = rng.randint(1, V, size=int(lengths.sum())).astype(np.int32)
    datalen = np.full(B, T, np.int32)

    err, grad = ctc.ctcLoss(torch.from_numpy(data), datalen, labels, lengths, 0)
    hostErr, hostGrad, _ = ctc.hostCTCLoss(data, datalen, labels, lengths, 0)

    assert err.item() == pytest.approx(float(hostErr), rel=1e-5)
    _closeGrad(-grad.numpy(), hostGrad)


def testCtcCostTwin():
    """The ``CTC`` cost: its error over the batch and its gradient against
    the JAX package's cost, int32 checks and the batch size."""
    pytest.importorskip("puzzlelib_tpu.cost", reason="the twins need the JAX package")
    from puzzlelib_tpu.backend import gpuarray as jgpu
    from puzzlelib_tpu.cost import CTC as JCTC

    data, datalen, labels, lengths = _batch(seed=9)
    jcost, tcost = JCTC(blank=0, vocabsize=6), TCTC(blank=0, vocabsize=6)

    jerr, jgrad = jcost((jgpu.to_gpu(data), jgpu.to_gpu(datalen)), (jgpu.to_gpu(labels), jgpu.to_gpu(lengths)))
    terr, tgrad = tcost((torch.from_numpy(data), torch.from_numpy(datalen)),
                        (torch.from_numpy(labels), torch.from_numpy(lengths)))

    assert terr == pytest.approx(jerr, rel=1e-5)
    assert tcost.batchsize == 4
    _closeGrad(tgrad.numpy(), jgrad.get())

    with pytest.raises(CostError):
        tcost((torch.from_numpy(data), torch.from_numpy(datalen).long()),
              (torch.from_numpy(labels), torch.from_numpy(lengths)))

    with pytest.raises(CostError):
        TCTC(blank=0, vocabsize=5)((torch.from_numpy(data), torch.from_numpy(datalen)),
                                   (torch.from_numpy(labels), torch.from_numpy(lengths)))

    with pytest.raises(CostError):
        TCTC(blank=7, vocabsize=6)


@pytest.mark.cuda
def testCtcOnCardMatchesCpuAndRepeats(monkeypatch):
    """At Wave2Letter's lengths on the card: the CPU's error and gradient
    within 1e-6 relative, and a second call the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CTC's CUDA path runs only on the card")

    rng = np.random.RandomState(1)
    T, B, V = 800, 8, 29
    data = rng.randn(T, B, V).astype(np.float32)
    lengths = rng.randint(120, 241, size=B).astype(np.int32)
    labels = rng.randint(1, V, size=int(lengths.sum())).astype(np.int32)
    datalen = np.full(B, T, np.int32)

    cpuErr, cpuGrad = ctc.ctcLoss(torch.from_numpy(data), datalen, labels, lengths, 0)
    monkeypatch.setattr(TConfig, "device", "cuda")
    first = ctc.ctcLoss(torch.from_numpy(data).cuda(), datalen, labels, lengths, 0)
    second = ctc.ctcLoss(torch.from_numpy(data).cuda(), datalen, labels, lengths, 0)

    assert first[1].is_cuda
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert first[0].item() == pytest.approx(cpuErr.item(), rel=1e-6)
    _closeGrad(first[1].cpu().numpy(), cpuGrad.numpy(), 1e-6)
