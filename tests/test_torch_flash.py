"""Kernel K4 (the port's flash-attention forward) against the JAX package.

On the CPU the wrapper runs its plain PyTorch version, which is held, for
``out`` and ``lse``, to the Pallas kernel in interpret mode
(``_flashForward(..., interpret=True)``, as tests/test_attention.py runs it)
and to the reference's composed ``attention``.  The CUDA case runs only where
a card is present.
"""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch.ops.hopper import flash


def _jax():
    """(jax.numpy, the reference's flash forward, its composed attention).
    The twins skip where the JAX package does not import, as on the card's
    machine, where only the CUDA case runs."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    import jax.numpy as jnp
    from puzzlelib_tpu.ops.attention import attention
    from puzzlelib_tpu.ops.pallas.flash import _flashForward

    return jnp, _flashForward, attention


@pytest.fixture(autouse=True)
def _onCpu(monkeypatch):
    """The port runs on the card unless asked for the CPU: these tests ask
    (the card-only case makes its tensors on "cuda" itself)."""
    from puzzlelib_tpu_torch import config as Config

    monkeypatch.setattr(Config, "device", "cpu")


def _qkv(seed, b, h, seqQ, seqK, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, seq, d).astype(np.float32) for seq in (seqQ, seqK, seqK)]


def _relMax(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


# the slice's head dim, self-attention with and without the mask, and
# seqQ < seqK (the bottom-right offset); f32 as tests/test_attention.py holds
# the Pallas kernel to XLA, bf16 at one bf16 rounding of P and of out
_CASES = [((2, 2, 80, 32), 80, False), ((2, 2, 80, 32), 80, True), ((2, 2, 48, 32), 80, True)]
_BOUNDS = {"float32": (torch.float32, 1e-5), "bfloat16": (torch.bfloat16, 1e-2)}


@pytest.mark.parametrize("dtype", sorted(_BOUNDS))
@pytest.mark.parametrize("shape, seqK, causal", _CASES)
def testPlainMatchesPallasInterpret(shape, seqK, causal, dtype):
    jnp, flashForward, _ = _jax()
    tdtype, bound = _BOUNDS[dtype]

    b, h, seqQ, d = shape
    q, k, v = _qkv(0, b, h, seqQ, seqK, d)

    jout, jlse = flashForward(*(jnp.asarray(a, dtype) for a in (q, k, v)), causal, 256, 256, True)
    out, lse = flash.flash(*(torch.from_numpy(a).to(tdtype) for a in (q, k, v)), causal)

    want = np.asarray(jout.astype(jnp.float32))
    assert out.dtype == tdtype and tuple(out.shape) == want.shape
    assert lse.dtype == torch.float32 and tuple(lse.shape) == jlse.shape == (b * h, 1, seqQ)

    assert _relMax(out.float().numpy(), want) <= bound
    assert _relMax(lse.numpy(), np.asarray(jlse)) <= 1e-5   # f32 statistics of the same f32 scores


@pytest.mark.parametrize("causal", [False, True])
def testPlainMatchesReferenceAttention(causal):
    """``out`` is the reference's composed attention (``ops/attention.py``)."""
    jnp, _, attention = _jax()
    q, k, v = _qkv(1, 2, 3, 64, 96, 64)

    want = np.asarray(attention(*(jnp.asarray(a) for a in (q, k, v)), causal=causal))
    out, _ = flash.plain(*(torch.from_numpy(a) for a in (q, k, v)), causal)

    assert _relMax(out.numpy(), want) <= 1e-5


def testFullyMaskedRowsAverageEveryKey():
    """With seqQ > seqK the first causal rows see no key: the -1e30 mask
    gives every key the same weight, as the TPU kernel does, and lse is
    -1e30 + log(seqK)."""
    jnp, flashForward, _ = _jax()
    q, k, v = _qkv(2, 1, 2, 80, 48, 32)

    jout, jlse = flashForward(*(jnp.asarray(a) for a in (q, k, v)), True, 256, 256, True)
    out, lse = flash.flash(*(torch.from_numpy(a) for a in (q, k, v)), True)

    blind = 80 - 48
    assert np.allclose(out[:, :, :blind].numpy(), np.broadcast_to(v.mean(axis=2, keepdims=True), (1, 2, blind, 32)),
                       atol=1e-5)
    assert np.allclose(lse[:, 0, :blind].numpy(), np.float32(-1e30))
    assert _relMax(out.numpy(), np.asarray(jout)) <= 1e-5
    assert np.array_equal(lse.numpy()[:, :, :blind], np.asarray(jlse)[:, :, :blind])


def testWrapperRejectsWhatTheKernelDoesNotTake():
    q = torch.zeros((1, 2, 8, 32))

    with pytest.raises(ValueError):
        flash.flash(q, torch.zeros((1, 2, 8, 16)), torch.zeros((1, 2, 8, 16)))

    with pytest.raises(ValueError):
        flash.flash(q, torch.zeros((1, 3, 8, 32)), torch.zeros((1, 3, 8, 32)))

    with pytest.raises(TypeError):
        flash.flash(q, q.to(torch.bfloat16), q)

    with pytest.raises(ValueError):
        flash.flash(q, torch.zeros((1, 2, 0, 32)), torch.zeros((1, 2, 0, 32)))

    with pytest.raises(ValueError):
        meta = q.to("meta")
        flash.flash(meta, meta, meta)


def testCpuTensorsTakeThePlainVersionAndCountNoLaunch():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(3, 1, 2, 16, 16, 32))
    before = flash.launches

    out, lse = flash.flash(q, k, v, True)
    ref, refLse = flash.plain(q, k, v, True)

    assert flash.launches == before
    assert torch.equal(out, ref) and torch.equal(lse, refLse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape, seqK, causal", [((64, 4, 80, 32), 80, False), ((2, 3, 80, 32), 200, True),
                                                 ((2, 3, 200, 64), 80, True), ((1, 2, 130, 128), 77, False),
                                                 ((1, 2, 333, 64), 333, True)])
def testKernelMatchesPlainOnCard(shape, seqK, causal, dtype):
    """The kernel against its plain version: out within 1e-2 of max |plain|
    (both round P to the input's type; they differ by where it is rounded,
    the order of the f32 sums and one final rounding), lse within 1e-4 of
    max |plain| over the rows that see a key.  A causal row that sees none
    (seqQ > seqK) has lse -1e30 + log(seqK) in both, which is -1e30 in f32:
    it is checked exactly and kept out of the relative error, which it would
    swamp."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA C++ built with nvcc")

    b, h, seqQ, d = shape
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = [torch.randn((b, h, seq, d), generator=gen, device="cuda").to(dtype) for seq in (seqQ, seqK, seqK)]

    before = flash.launches
    out, lse = flash.flash(q, k, v, causal)
    ref, refLse = flash.plain(q, k, v, causal)
    torch.cuda.synchronize()

    assert flash.launches == before + 1
    assert out.dtype == dtype and lse.shape == (b * h, 1, seqQ)
    assert ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item() <= 1e-2

    blind = max(0, seqQ - seqK) if causal else 0
    masked = torch.tensor(-1e30, dtype=torch.float32) + torch.tensor(float(np.log(seqK)), dtype=torch.float32)
    assert torch.equal(lse[:, 0, :blind].cpu(), masked.expand(b * h, blind))
    assert torch.equal(refLse[:, 0, :blind].cpu(), masked.expand(b * h, blind))

    seen, refSeen = lse[:, 0, blind:], refLse[:, 0, blind:]
    assert ((seen - refSeen).abs().max() / refSeen.abs().max()).item() <= 1e-4

    with pytest.raises(TypeError):
        flash.flash(q.float(), k.float(), v.float(), causal)


# -- the backward: K5a (dq) and K5b (dk, dv) -------------------------------------------------

def _backwardInputs(seed, b, h, seqQ, seqK, d):
    """q, k, v and the output gradient as host f32 arrays."""
    q, k, v = _qkv(seed, b, h, seqQ, seqK, d)
    do = np.random.RandomState(seed + 100).randn(b, h, seqQ, d).astype(np.float32)
    return q, k, v, do


# self-attention with and without the mask, seqQ < seqK (the bottom-right
# offset) and seqQ > seqK, whose first 32 causal rows see no key: there the
# port follows the Pallas kernel (p = 1 for every key) and not XLA's NaN.
# f32 as the forward's twins; bf16 at one bf16 rounding of P and of dS, which
# both versions round, and of the outputs
_BACKWARD_CASES = [((2, 2, 80, 32), 80, False), ((2, 2, 80, 32), 80, True), ((2, 2, 48, 32), 80, True),
                   ((2, 2, 80, 32), 48, True)]


@pytest.mark.parametrize("dtype", sorted(_BOUNDS))
@pytest.mark.parametrize("shape, seqK, causal", _BACKWARD_CASES)
def testBackwardPlainMatchesPallasInterpret(shape, seqK, causal, dtype):
    """``backwardPlain`` against ``_flashBackward`` in interpret mode, both
    fed the reference forward's out and lse."""
    jnp, flashForward, _ = _jax()
    from puzzlelib_tpu.ops.pallas.flash import _flashBackward

    tdtype, bound = _BOUNDS[dtype]
    b, h, seqQ, d = shape
    host = _backwardInputs(20, b, h, seqQ, seqK, d)

    jq, jk, jv, jdo = (jnp.asarray(a, dtype) for a in host)
    jout, jlse = flashForward(jq, jk, jv, causal, 256, 256, True)
    want = _flashBackward(jq, jk, jv, jout, jlse, jdo, causal, 256, 256, True)

    q, k, v, do = (torch.from_numpy(a).to(tdtype) for a in host)
    out = torch.from_numpy(np.array(jout.astype(jnp.float32))).to(tdtype)
    got = flash.backwardPlain(q, k, v, out, torch.from_numpy(np.array(jlse)), do, causal)

    for g, w, t in zip(got, want, (q, k, v)):
        w = np.asarray(w.astype(jnp.float32))
        assert g.dtype == tdtype and g.shape == t.shape
        assert np.isfinite(w).all()
        assert _relMax(g.float().numpy(), w) <= bound


@pytest.mark.parametrize("causal", [False, True])
def testFlashAttentionAutogradRunsTheBackward(causal):
    """``FlashAttention`` under ``torch.autograd.grad`` gives what
    ``backwardPlain`` gives on the forward's out and lse."""
    q, k, v, do = (torch.from_numpy(a) for a in _backwardInputs(21, 2, 3, 40, 56, 32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    out = flash.flashAttention(*leaves, causal)
    got = torch.autograd.grad(out, leaves, do)

    ref, lse = flash.plain(q, k, v, causal)
    want = flash.backwardPlain(q, k, v, ref, lse, do, causal)

    assert torch.equal(out.detach(), ref)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def testBackwardOnCpuTakesThePlainVersionAndChecks():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in _backwardInputs(22, 1, 2, 16, 24, 32))
    out, lse = flash.flash(q, k, v, True)
    before = (flash.launchesDq, flash.launchesDkv)

    got = flash.backward(q, k, v, out, lse, do, True)
    want = flash.backwardPlain(q, k, v, out, lse, do, True)

    assert (flash.launchesDq, flash.launchesDkv) == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))

    with pytest.raises(ValueError):
        flash.backward(q, k, v, out, lse.reshape(2, 16), do, True)

    with pytest.raises(ValueError):
        flash.backward(q, k, v, out, lse, do[:, :, :8], True)

    with pytest.raises(ValueError):
        flash.backward(q, k, v, out.float(), lse, do, True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape, seqK, causal", [((64, 4, 80, 32), 80, False), ((64, 4, 80, 32), 80, True),
                                                 ((2, 3, 80, 32), 200, True), ((2, 3, 200, 64), 80, True),
                                                 ((1, 2, 130, 128), 77, False), ((1, 2, 333, 64), 333, True),
                                                 ((2, 2, 80, 128), 48, True), ((1, 3, 257, 128), 300, True),
                                                 ((2, 2, 65, 64), 129, False), ((2, 2, 127, 64), 255, False),
                                                 ((1, 3, 65, 32), 255, True), ((2, 2, 127, 128), 255, True),
                                                 ((1, 2, 129, 32), 127, False), ((1, 2, 255, 128), 129, True)])
def testBackwardKernelsMatchPlainOnCard(shape, seqK, causal, dtype):
    """K5a and K5b against ``backwardPlain`` on the kernel forward's out and
    lse: dq, dk and dv within 1e-2 of max |plain| (both round P and dS to the
    input's type for the products; they differ by the order of the f32 sums,
    by exp2 against exp where a rounding of P or dS flips, and by one final
    rounding), one launch of each kernel, and the same bits on a second call
    (no atomics).  The shapes cross the kernels' 64-row tiles (seqQ 65 and
    127, seqK 129 and 255), with the causal offset both ways and query rows
    that see no key (seqQ > seqK causal) at d 32 and 128."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ built with nvcc")

    b, h, seqQ, d = shape
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v, do = [torch.randn((b, h, seq, d), generator=gen, device="cuda").to(dtype)
                   for seq in (seqQ, seqK, seqK, seqQ)]
    out, lse = flash.flash(q, k, v, causal)

    before = (flash.launchesDq, flash.launchesDkv)
    got = flash.backward(q, k, v, out, lse, do, causal)
    want = flash.backwardPlain(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()

    assert (flash.launchesDq - before[0], flash.launchesDkv - before[1]) == (1, 1)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        assert bool(torch.isfinite(g).all())
        assert ((g.float() - w.float()).abs().max() / w.float().abs().max()).item() <= 1e-2

    again = flash.backward(q, k, v, out, lse, do, causal)
    assert all(torch.equal(g, a) for g, a in zip(got, again))

    with pytest.raises(TypeError):
        flash.backward(q.float(), k.float(), v.float(), out.float(), lse, do.float(), causal)
