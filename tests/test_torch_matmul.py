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


@pytest.mark.parametrize("m, n, k, dtype, aligned, path", [
    (32, 4096, 25088, torch.bfloat16, True, "wgmma-64"),   # fc6 at batch 32
    (64, 1000, 4096, torch.float16, True, "wgmma-64"),
    (65, 4096, 4096, torch.float16, True, "wgmma-64"),     # bound by its bytes
    (5120, 512, 128, torch.bfloat16, True, "wgmma-64"),    # the transformer's mlp-up
    (8192, 8192, 8192, torch.bfloat16, True, "wgmma-128"), # bound by its operations
    (4096, 4096, 4096, torch.float16, True, "wgmma-128"),
    (2048, 2048, 2048, torch.bfloat16, True, "wgmma-64"),  # 256 tiles of 128 rows: under two an SM
    (64, 2, 128, torch.bfloat16, True, "tiled"),           # the transformer head's N = 2
    (100, 60, 200, torch.bfloat16, True, "tiled"),         # the ragged shape
    (32, 4096, 4100, torch.float16, True, "tiled"),        # K off a multiple of 8
    (32, 4096, 4096, torch.bfloat16, False, "tiled"),      # a base off 16 bytes
    (64, 8, 0, torch.bfloat16, True, "tiled-vec"),         # K = 0: TMA describes no empty matrix
    (32, 4096, 4096, torch.float32, True, "tiled-vec"),    # f32 stays on FFMA
    (32, 4096, 4096, torch.int8, True, "wgmma-64"),        # fc7 at batch 32: int8 on wgmma, 64 rows
    (32, 1000, 27, torch.int8, True, "tiled"),             # K off a multiple of 16: WMMA
    (32, 4096, 25088, torch.int8, True, "wgmma-64"),       # fc6
    (32, 1000, 4096, torch.int8, True, "wgmma-64"),        # fc8: N off 16 is no bar for B^T's rows
    (1605632, 64, 32, torch.int8, True, "wgmma-128"),      # conv1_1 with K padded to 32
    (1605632, 64, 576, torch.int8, True, "wgmma-128"),     # conv1_2
    (100352, 256, 2304, torch.int8, True, "wgmma-128"),    # conv3_2
    (6272, 512, 4608, torch.int8, True, "wgmma-128"),      # conv5_1
    (64, 17, 16, torch.int8, True, "wgmma-64"),            # the last row count on 64-row blocks
    (65, 17, 48, torch.int8, True, "wgmma-128"),
    (100, 60, 200, torch.int8, True, "tiled"),             # the ragged shape: K off 16
    (100, 64, 208, torch.int8, False, "tiled"),            # a base off 16 bytes
    (64, 16, 0, torch.int8, True, "tiled-vec"),            # K = 0: TMA describes no empty matrix
])
def testRouteChoosesTheKernelFromTheShape(m, n, k, dtype, aligned, path):
    """bf16 and f16 products that TMA can describe go to wgmma, with 128-row
    blocks where the operations bind and the tiles fill an H100's 132 SMs
    twice; int8 products with K a multiple of 16 go to wgmma too, with
    64-row blocks where M <= 64 and 128-row ones elsewhere; N = 2, ragged
    shapes, unaligned bases and f32 stay on the tiled kernels."""
    from puzzlelib_tpu_torch.ops.hopper import matmul

    assert matmul._route(m, n, k, dtype, aligned, 132) == path


def _cardOperands(device, dtype, m, k, n, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((m, k), generator=gen, device=device).to(dtype)
    b = (torch.randn((k, n), generator=gen, device=device) / k ** 0.5).to(dtype)
    return a, b


def _relErr(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


_HALF = [torch.bfloat16, torch.float16]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _HALF)
def testWgmmaSingleTile(dtype):
    """One block, one K step of four m64n128k16 products: the swizzled
    descriptors of A (K-major) and B (MN-major).  A one-hot A picks B's rows,
    so a wrong descriptor shows as a wrong row or column, exactly."""
    device = _cuda()
    from puzzlelib_tpu_torch.ops.hopper import matmul

    m, k, n = 64, 64, 128
    _, b = _cardOperands(device, dtype, m, k, n)
    pick = torch.arange(m, device=device) * 5 % k
    a = torch.zeros((m, k), device=device, dtype=dtype)
    a[torch.arange(m, device=device), pick] = 1

    assert matmul._route(m, n, k, dtype, True, 132) == "wgmma-64"
    assert torch.equal(matmul.matmul(a, b), b[pick])

    a, b = _cardOperands(device, dtype, m, k, n, seed=1)
    assert _relErr(matmul.matmul(a, b), matmul.plain(a, b)) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _HALF)
@pytest.mark.parametrize("path", ["wgmma-64", "wgmma-128"])
@pytest.mark.parametrize("m, k, n", [(1, 64, 128), (63, 40, 200), (65, 264, 136), (130, 200, 72), (130, 8, 8),
                                     (200, 1032, 392)])
def testWgmmaTileEdges(m, k, n, path, dtype):
    """Shapes that cross every tile edge: M of 1, 63, 65 and 130, N off a
    multiple of 128 and below 64, K below 64 and off a multiple of 64; on
    both block heights (one and two consumer warpgroups), within the bound
    of chip_smoke.py's GEMM_BOUND."""
    device = _cuda()
    from puzzlelib_tpu_torch.ops.hopper import matmul

    a, b = _cardOperands(device, dtype, m, k, n)
    got = torch.full((m, n), float("nan"), device=device, dtype=dtype)
    before = matmul.launchesWgmma
    matmul._launch(a, b, got, path)
    torch.cuda.synchronize()

    assert matmul.launchesWgmma == before + 1
    assert _relErr(got, matmul.plain(a, b)) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _HALF)
@pytest.mark.parametrize("m, k, n", [(32, 4096, 1000), (32, 4104, 264), (32, 25088, 512)])
def testWgmmaSplitK(m, k, n, dtype):
    """Split-K shapes (M = 32, K >= 4096): several slices, summed in order,
    and the same bits from a second call."""
    device = _cuda()
    from puzzlelib_tpu_torch.ops.hopper import matmul

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splitsOf, _ = matmul._entries()
    assert splitsOf(m, n, k, matmul._DTYPES[dtype], matmul._PATHS["wgmma-64"], sms) > 1

    a, b = _cardOperands(device, dtype, m, k, n)
    got = matmul.matmul(a, b)
    assert _relErr(got, matmul.plain(a, b)) <= 1e-2
    assert torch.equal(matmul.matmul(a, b), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _HALF)
def testWgmmaRepeatsBitForBit(dtype):
    """The transformer's products, a one-block product and a 128-row routed
    one give the same bits twice: no atomics, a fixed order of sums."""
    device = _cuda()
    from puzzlelib_tpu_torch.ops.hopper import matmul

    for m, k, n in [(5120, 128, 512), (5120, 512, 128), (8, 256, 64), (2048, 4096, 4096)]:
        a, b = _cardOperands(device, dtype, m, k, n)
        assert torch.equal(matmul.matmul(a, b), matmul.matmul(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _HALF)
@pytest.mark.parametrize("m, k, n, wgmma", [(64, 128, 512, True), (64, 128, 2, False), (100, 200, 60, False)])
def testRouteCounters(m, k, n, wgmma, dtype):
    """Every float launch counts in ``launches``; the wgmma ones also in
    ``launchesWgmma``: an aligned shape moves both, the head's N = 2 and the
    ragged shape only the first."""
    device = _cuda()
    from puzzlelib_tpu_torch.ops.hopper import matmul

    a, b = _cardOperands(device, dtype, m, k, n)
    launches, wgmmaLaunches = matmul.launches, matmul.launchesWgmma
    got = matmul.matmul(a, b)

    assert matmul.launches == launches + 1
    assert matmul.launchesWgmma == wgmmaLaunches + int(wgmma)
    assert _relErr(got, matmul.plain(a, b)) <= 1e-2
