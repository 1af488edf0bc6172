"""Kernel K1 (the port's tiled GEMM) and the BLAS dispatch, against the JAX
package.

On the CPU the GEMM wrapper runs its plain PyTorch version; it is held to the
Pallas kernel in interpret mode, as tests/test_pallas.py runs it.  The
dispatch rules of ``Blas.mulMatrixOnMatrix`` are held to the reference's by
recording when the reference calls its Pallas GEMM.  The CUDA case runs only
where a card is present.
"""

import itertools

import numpy as np
import pytest
import torch


def _jnp():
    """jax.numpy for the twin tests.  They skip where the JAX package does not
    import, as on the card's machine, where only the CUDA cases run."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    import jax.numpy as jnp

    return jnp


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA C++ built with nvcc")

    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _onCpu(monkeypatch):
    """The port runs on the card unless asked for the CPU: these tests ask
    (the card-only cases make their tensors on "cuda" themselves)."""
    from puzzlelib_tpu_torch import config as Config

    monkeypatch.setattr(Config, "device", "cpu")


_DTYPES = {"float32": (torch.float32, 1e-5), "bfloat16": (torch.bfloat16, 1e-2)}


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("m, k, n", [(256, 384, 256), (100, 200, 60)])
def testPlainMatchesPallasInterpret(m, k, n, dtype):
    """f32 within 1e-5 of max|ref| (sum order only); bf16 within 1e-2: both
    round one f32 sum to bf16, so they differ by at most about an ulp."""
    jnp = _jnp()
    from puzzlelib_tpu.ops.pallas.matmul import matmulPadded
    from puzzlelib_tpu_torch.ops.hopper import matmul

    tdt, bound = _DTYPES[dtype]
    jdt = getattr(jnp, dtype)

    rng = np.random.RandomState(0)
    a = rng.randn(m, k).astype(np.float32)
    b = rng.randn(k, n).astype(np.float32)

    want = matmulPadded(jnp.asarray(a, jdt), jnp.asarray(b, jdt), bm=128, bn=128, bk=128, interpret=True)
    want = np.asarray(want.astype(jnp.float32))

    launchesBefore = matmul.launches
    got = matmul.matmul(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt))

    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    assert np.abs(got.float().numpy() - want).max() <= bound * np.abs(want).max()
    assert matmul.launches == launchesBefore   # the CPU takes the plain version, no launch


def testWrapperRejectsWhatTheKernelDoesNotTake():
    from puzzlelib_tpu_torch.ops.hopper import matmul

    with pytest.raises(ValueError):
        matmul.matmul(torch.zeros(4, 5), torch.zeros(6, 3))

    with pytest.raises(TypeError):
        matmul.matmul(torch.zeros(4, 5), torch.zeros(5, 3, dtype=torch.float64))

    with pytest.raises(TypeError):
        matmul.matmul(torch.zeros(4, 5), torch.zeros(5, 3, dtype=torch.bfloat16))


@pytest.mark.parametrize("transpA, transpB, alpha, outBeta",
                         list(itertools.product((False, True), (False, True), (1.0, 2.0),
                                                (None, 0.0, 0.5))))
def testDispatchRulesMatchReference(monkeypatch, transpA, transpB, alpha, outBeta):
    """The port sends a product to K1 exactly when the reference sends it to
    its Pallas GEMM (``gemmAlgo="pallas"``), and both give the same values."""
    jnp = _jnp()
    from puzzlelib_tpu import config as JConfig
    from puzzlelib_tpu.backend import blas as JBlas, gpuarray as jgpu
    from puzzlelib_tpu.ops.pallas import matmul as plmm
    from puzzlelib_tpu_torch.backend import blas as TBlas

    calls = []
    monkeypatch.setattr(JConfig, "gemmAlgo", "pallas")
    monkeypatch.setattr(plmm, "matmulPadded", lambda a, b, **kw: calls.append(1) or jnp.dot(a, b))

    rng = np.random.RandomState(3)
    m, k, n = 16, 24, 8
    a = rng.randn(*((k, m) if transpA else (m, k))).astype(np.float32)
    b = rng.randn(*((n, k) if transpB else (k, n))).astype(np.float32)
    c = rng.randn(m, n).astype(np.float32)

    beta = 0.0 if outBeta is None else outBeta
    jout = None if outBeta is None else jgpu.to_gpu(c)
    tout = None if outBeta is None else torch.from_numpy(c.copy())

    want = JBlas.mulMatrixOnMatrix(jgpu.to_gpu(a), jgpu.to_gpu(b), out=jout, transpA=transpA, transpB=transpB,
                                   alpha=alpha, beta=beta).get()

    A, B = torch.from_numpy(a), torch.from_numpy(b)
    got = TBlas.mulMatrixOnMatrix(A, B, out=tout, transpA=transpA, transpB=transpB, alpha=alpha, beta=beta)

    hasOut = outBeta is not None and beta != 0.0
    assert TBlas.kernelTakes(A, B, transpA, transpB, alpha, hasOut) == bool(calls)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def testSumOnMatrixMatchesReference():
    _jnp()
    from puzzlelib_tpu.backend import blas as JBlas, gpuarray as jgpu
    from puzzlelib_tpu_torch.backend import blas as TBlas

    rng = np.random.RandomState(4)
    a = rng.randn(12, 7).astype(np.float32)
    out = rng.randn(7).astype(np.float32)

    for cols in (True, False):
        want = JBlas.sumOnMatrix(jgpu.to_gpu(a), cols=cols).get()
        got = TBlas.sumOnMatrix(torch.from_numpy(a), cols=cols).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    want = JBlas.sumOnMatrix(jgpu.to_gpu(a), out=jgpu.to_gpu(out), alpha=0.5, beta=2.0).get()
    got = TBlas.sumOnMatrix(torch.from_numpy(a), out=torch.from_numpy(out.copy()), alpha=0.5, beta=2.0)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, bound", [(torch.bfloat16, 1e-2), (torch.float32, 1e-4), (torch.float16, 1e-2)])
def testKernelMatchesPlainOnCard(dtype, bound):
    """Ragged and aligned shapes (the scalar and vector load paths), and the
    dispatch from ``mulMatrixOnMatrix``; bounds as in chip_smoke.py."""
    device = _cuda()
    from puzzlelib_tpu_torch.backend import blas as TBlas
    from puzzlelib_tpu_torch.ops.hopper import matmul

    gen = torch.Generator(device=device).manual_seed(0)
    for m, k, n in [(32, 4096, 1000), (100, 200, 60), (1, 7, 3), (130, 264, 72)]:
        a = torch.randn((m, k), generator=gen, device=device).to(dtype)
        b = (torch.randn((k, n), generator=gen, device=device) / k ** 0.5).to(dtype)

        before = matmul.launches
        got = TBlas.mulMatrixOnMatrix(a, b)
        ref = matmul.plain(a, b)
        torch.cuda.synchronize()

        assert matmul.launches == before + 1
        assert ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item() <= bound
