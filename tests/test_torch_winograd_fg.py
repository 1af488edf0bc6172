"""Kernel K3 (the port's transform-domain Winograd bwd-filter) and K2 as the
stride-1 bwd-data, against the JAX package.

On the CPU the wrappers run their plain PyTorch versions, which are held to
the Pallas kernels in interpret mode (as tests/test_pallas.py runs them).
The CUDA cases run only where a card is present.
"""

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


def _inputs(seed, n, c, h, w, co, p):
    """x (N, C, H, W) and the gradient dy of its pad-p 3x3 conv."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c, h, w).astype(np.float32)
    dy = (rng.randn(n, co, h + 2 * p - 2, w + 2 * p - 2) * 0.1).astype(np.float32)
    return x, dy


def _nhwc(jnp, a, dtype):
    return jnp.asarray(a.transpose(0, 2, 3, 1), dtype)


def _relMax(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


# the cases of tests/test_pallas.py's bwd-filter tests; bi forces the
# reference's multi-block path
_FG_CASES = [(2, 128, 8, 8, 128, 1, None), (1, 128, 9, 7, 128, 0, None), (1, 128, 12, 8, 128, 1, 2)]


@pytest.mark.parametrize("n, c, h, w, co, p, bi", _FG_CASES)
def testFilterGradPlainMatchesPallasInterpretF32(n, c, h, w, co, p, bi):
    """f32 within 1e-4 of max|ref|: the same algorithm with its sums over
    tiles in another order."""
    jnp = _jnp()
    from puzzlelib_tpu.ops.pallas import winograd as jwino
    from puzzlelib_tpu_torch.ops.hopper import winograd

    x, dy = _inputs(8, n, c, h, w, co, p)
    want = np.asarray(jwino.filterGradNHWC(_nhwc(jnp, x, jnp.float32), _nhwc(jnp, dy, jnp.float32), (p, p), bi=bi,
                                           interpret=True))

    before = winograd.filterGradLaunches
    got = winograd.filterGrad(torch.from_numpy(x), torch.from_numpy(dy), (p, p))

    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (co, c, 3, 3)
    assert _relMax(got.numpy(), want) <= 1e-4
    assert winograd.filterGradLaunches == before


def _replayFgKernel(jnp, jwino, xs, ys, n, c, co, twp, mb):
    """The statements of the reference's ``_fgKernel`` run eagerly on its own
    row-phase slabs (one block per image), each jnp op rounding to its
    operands' type: dU (16, C, CO) in float64."""
    xs, ys = np.asarray(xs), np.asarray(ys)
    acc = np.zeros((16, c, co))

    for i in range(n):
        def d(a, b):
            off = (a // 2) * twp + b // 2
            return jnp.asarray(xs[a % 2, i, off:off + mb, (b % 2) * c:(b % 2 + 1) * c])

        for xi in range(4):
            t1 = [(d(0, b) - d(2, b), d(1, b) + d(2, b), d(2, b) - d(1, b), d(1, b) - d(3, b))[xi] for b in range(4)]

            for nu, v in enumerate((t1[0] - t1[2], t1[1] + t1[2], t1[2] - t1[1], t1[1] - t1[3])):
                mbar = None
                for ap, sa in jwino._ACOL[xi]:
                    for bp, sb in jwino._ACOL[nu]:
                        term = jnp.asarray(ys[ap, i, :mb, bp * co:(bp + 1) * co])
                        term = -term if sa * sb < 0 else term
                        mbar = term if mbar is None else mbar + term

                acc[xi * 4 + nu] += np.asarray(v, np.float64).T @ np.asarray(mbar, np.float64)

    return acc


@pytest.mark.parametrize("n, c, h, w, co, p", [(2, 128, 8, 8, 128, 1), (1, 128, 9, 7, 128, 0)])
def testFilterGradPlainKeepsTheReferenceRoundingPoints(n, c, h, w, co, p):
    """bf16: the plain version against the reference kernel's own statements
    replayed eagerly (its dU taken through the same G^T dU G), within 1e-5
    of max|ref|: both round V's two butterfly stages and Mbar's sums to bf16
    at the same points, so only the order of the f32 sums over tiles
    differs.  (Interpret mode, as XLA runs it on the CPU, does not round at
    those points; the next test bounds that difference.)"""
    jnp = _jnp()
    from puzzlelib_tpu.ops.pallas import winograd as jwino
    from puzzlelib_tpu_torch.ops.hopper import winograd

    x, dy = _inputs(9, n, c, h, w, co, p)
    oh, ow = dy.shape[2:]
    th, tw = -(-oh // 2), -(-ow // 2)
    twp, mb = tw + 1, th * (tw + 1)

    xl = jnp.pad(_nhwc(jnp, x, jnp.bfloat16), ((0, 0), (p, 2 * (th + 2) - h - p), (p, 2 * twp - w - p), (0, 0)))
    xs = jwino._rowSlabs(xl, n, th + 2, twp, c, jwino._fetchRows(th, twp))
    dyl = jnp.pad(_nhwc(jnp, dy, jnp.bfloat16), ((0, 0), (0, 2 * th - oh), (0, 2 * twp - ow), (0, 0)))
    ys = jwino._rowSlabs(dyl, n, th, twp, co, mb)
    want = _replayFgKernel(jnp, jwino, xs, ys, n, c, co, twp, mb)

    xt, dyt = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(dy).to(torch.bfloat16)
    got = winograd.filterGradPlain(xt, dyt, (p, p))

    assert _relMax(got.numpy(), winograd.filterFromTransform(torch.from_numpy(want).float()).numpy()) <= 1e-5


@pytest.mark.parametrize("n, c, h, w, co, p, bi", _FG_CASES)
def testFilterGradPlainMatchesPallasInterpretBf16(n, c, h, w, co, p, bi):
    """bf16 inputs within 1e-2 of max|ref|: XLA on the CPU runs the
    interpreted kernel's bf16 adds without rounding at the kernel's stated
    points, which moves its dU by up to about one bf16 ulp (2^-8, 4e-3) of
    the transform values (measured 5.0e-3 to 5.5e-3 at these cases)."""
    jnp = _jnp()
    from puzzlelib_tpu.ops.pallas import winograd as jwino
    from puzzlelib_tpu_torch.ops.hopper import winograd

    x, dy = _inputs(8, n, c, h, w, co, p)
    want = np.asarray(jwino.filterGradNHWC(_nhwc(jnp, x, jnp.bfloat16), _nhwc(jnp, dy, jnp.bfloat16), (p, p),
                                           bi=bi, interpret=True), np.float32)

    got = winograd.filterGrad(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(dy).to(torch.bfloat16),
                              (p, p))

    assert got.dtype == torch.float32 and _relMax(got.numpy(), want) <= 1e-2


@pytest.mark.parametrize("n, c, h, w, co, p", [(2, 128, 9, 7, 128, 1), (1, 128, 6, 8, 256, 0), (1, 256, 5, 5, 128, 2)])
def testDataGradPlainMatchesPallasInterpret(n, c, h, w, co, p):
    """K2 as bwd-data: dy (N, CO, OH, OW) through w (CO, C, 3, 3) to dX
    (N, C, OH - 2p + 2, ...), f32 within 1e-4 of max|ref|, as K2's forward
    twin: the reference's ``dataGradNHWC`` is its forward on the rotated,
    io-swapped filter at pad 2 - p."""
    jnp = _jnp()
    from puzzlelib_tpu.ops.pallas import winograd as jwino
    from puzzlelib_tpu_torch.ops.hopper import winograd

    rng = np.random.RandomState(10)
    dy = rng.randn(n, co, h, w).astype(np.float32)
    wt = (rng.randn(co, c, 3, 3) * 0.1).astype(np.float32)

    want = np.asarray(jwino.dataGradNHWC(_nhwc(jnp, dy, jnp.float32), jnp.asarray(wt), (p, p),
                                         interpret=True)).transpose(0, 3, 1, 2)

    before = (winograd.launches, winograd.dataGradLaunches)
    got = winograd.dataGrad(torch.from_numpy(dy), torch.from_numpy(wt), (p, p)).numpy()

    assert got.shape == want.shape == (n, c, h - 2 * p + 2, w - 2 * p + 2)
    assert _relMax(got, want) <= 1e-4
    assert (winograd.launches, winograd.dataGradLaunches) == before


_FG_SHAPES = [
    ((32, 256, 56, 56), (32, 256, 56, 56), (1, 1), (1, 1), (1, 1), 1),
    ((2, 128, 9, 7), (2, 128, 7, 5), (1, 1), (0, 0), (1, 1), 1),
    ((2, 128, 16, 14), (2, 256, 16, 14), (1, 1), (1, 1), (1, 1), 1),
    ((32, 256, 56, 56), (32, 256, 28, 28), (2, 2), (1, 1), (1, 1), 1),
    ((32, 64, 56, 56), (32, 64, 56, 56), (1, 1), (1, 1), (1, 1), 1),
    ((32, 128, 56, 56), (32, 64, 56, 56), (1, 1), (1, 1), (1, 1), 1),
    ((32, 256, 56, 56), (32, 256, 56, 56), (1, 1), (2, 2), (1, 1), 1),
    ((32, 256, 56, 56), (32, 256, 56, 56), (1, 1), (2, 2), (2, 2), 1),
    ((32, 256, 56, 56), (32, 256, 56, 56), (1, 1), (1, 1), (1, 1), 2),
    ((1, 128, 10, 8), (1, 128, 8, 6), (1, 1), (0, 0), (1, 1), 1),
    ((1, 128, 10, 8), (1, 128, 7, 6), (1, 1), (0, 0), (1, 1), 1),
    ((1, 128, 5), (1, 128, 5), (1, ), (1, ), (1, ), 1),
]


@pytest.mark.parametrize("xshape, dyshape, stride, pad, dilation, groups", _FG_SHAPES)
def testFilterGradApplicableMatchesReference(xshape, dyshape, stride, pad, dilation, groups):
    """The port's rule is the reference's less its VMEM clause; none of these
    shapes hits that clause."""
    _jnp()
    from puzzlelib_tpu.ops.pallas import winograd as jwino
    from puzzlelib_tpu_torch.ops.hopper import winograd

    want = jwino.filterGradApplicable(xshape, dyshape, stride, pad, dilation, groups)
    assert winograd.filterGradApplicable(xshape, dyshape, stride, pad, dilation, groups) == want


def testFilterFromTransformIsTheAdjointOfFilterTransform():
    """<U(w), dU> = <w, G^T dU G> for any w and dU: the two transforms are
    adjoint, so the kernel's dU maps to the gradient of the weights."""
    from puzzlelib_tpu_torch.ops.hopper import winograd

    rng = np.random.RandomState(12)
    w = torch.from_numpy(rng.randn(5, 3, 3, 3)).float()
    du = torch.from_numpy(rng.randn(16, 3, 5)).float()

    lhs = (winograd.filterTransform(w).double() * du.double()).sum()
    rhs = (w.double() * winograd.filterFromTransform(du).double()).sum()

    assert abs(lhs - rhs).item() <= 1e-5 * abs(lhs).item()


def testWrappersRejectWhatTheKernelsDoNotTake():
    from puzzlelib_tpu_torch.ops.hopper import winograd

    with pytest.raises(ValueError):
        winograd.filterGrad(torch.zeros(1, 4, 8, 8), torch.zeros(1, 4, 7, 7), (1, 1))

    with pytest.raises(ValueError):
        winograd.filterGrad(torch.zeros(1, 4, 8, 8), torch.zeros(2, 4, 8, 8), (1, 1))

    with pytest.raises(ValueError):
        winograd.dataGrad(torch.zeros(1, 4, 8, 8), torch.zeros(4, 4, 3, 3), (3, 3))

    with pytest.raises(ValueError):
        winograd.filterGradNHWC(torch.zeros(1, 8, 8, 32, dtype=torch.bfloat16),
                                torch.zeros(1, 8, 8, 64, dtype=torch.bfloat16), (1, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("n, c, h, w, co, p", [(2, 128, 9, 7, 128, 0), (1, 32, 12, 10, 64, 1), (3, 256, 14, 14, 128, 1),
                                               (2, 64, 5, 5, 192, 1), (1, 32, 1, 1, 64, 1), (4, 128, 30, 26, 256, 1)])
def testFilterGradKernelMatchesPlainOnCard(n, c, h, w, co, p):
    """bf16 kernel against its plain version within 1e-3 of max|ref| (the
    chip_smoke.py bound), the same bits on a second call (the split partials
    add in a fixed order), and the conv dispatch's bwd-filter through it
    where it applies."""
    device = _cuda()
    from puzzlelib_tpu_torch.ops import conv as tconv
    from puzzlelib_tpu_torch.ops.hopper import winograd

    gen = torch.Generator(device=device).manual_seed(2)
    x = torch.randn((n, c, h, w), generator=gen, device=device).to(torch.bfloat16)
    dy = (torch.randn((n, co, h + 2 * p - 2, w + 2 * p - 2), generator=gen, device=device) * 0.1).to(torch.bfloat16)
    wt = torch.zeros((co, c, 3, 3), dtype=torch.bfloat16, device=device)

    before = winograd.filterGradLaunches
    got, again = winograd.filterGrad(x, dy, (p, p)), winograd.filterGrad(x, dy, (p, p))
    ref = winograd.filterGradPlain(x, dy, (p, p))
    torch.cuda.synchronize()

    assert winograd.filterGradLaunches == before + 2 and torch.equal(got, again)
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-3

    dw, _ = tconv.convNdBackwardParams(x, dy, wt, (1, 1), (p, p), (1, 1), 1)
    torch.cuda.synchronize()
    taken = winograd.filterGradApplicable(tuple(x.shape), tuple(dy.shape), (1, 1), (p, p), (1, 1), 1)

    assert winograd.filterGradLaunches == before + 2 + int(taken)
    assert ((dw.float() - ref).abs().max() / ref.abs().max()).item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("n, c, h, w, co, p", [(2, 128, 9, 7, 128, 1), (3, 256, 14, 14, 128, 1), (2, 128, 6, 5, 256, 0)])
def testDataGradKernelMatchesPlainOnCard(n, c, h, w, co, p):
    """bf16 bwd-data through K2 against the plain version within 1e-2 of
    max|ref| (K2's bound), and the conv dispatch's bwd-data through it."""
    device = _cuda()
    from puzzlelib_tpu_torch.ops import conv as tconv
    from puzzlelib_tpu_torch.ops.hopper import winograd

    gen = torch.Generator(device=device).manual_seed(3)
    dy = torch.randn((n, co, h + 2 * p - 2, w + 2 * p - 2), generator=gen, device=device).to(torch.bfloat16)
    wt = (torch.randn((co, c, 3, 3), generator=gen, device=device) * (2.0 / (9 * co)) ** 0.5).to(torch.bfloat16)

    before = (winograd.launches, winograd.dataGradLaunches)
    got = winograd.dataGrad(dy, wt, (p, p))
    ref = winograd.plain(dy, wt.flip((2, 3)).transpose(0, 1), (2 - p, 2 - p))
    routed = tconv.convNdBackwardData(dy, wt, (n, c, h, w), (1, 1), (p, p), (1, 1), 1)
    torch.cuda.synchronize()

    assert (winograd.launches, winograd.dataGradLaunches) == (before[0] + 2, before[1] + 2)
    for out in (got, routed):
        assert ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item() <= 1e-2
