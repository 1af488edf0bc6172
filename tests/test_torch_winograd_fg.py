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

    # K3 takes C a multiple of 64 and CO of 128 (filterGradApplicable admits
    # multiples of 128 of both); the channel rule is checked before the device
    for c, co in ((32, 128), (64, 64), (128, 192)):
        with pytest.raises(ValueError, match="multiples of 64 and 128"):
            winograd.filterGradNHWC(torch.zeros(1, 8, 8, c, dtype=torch.bfloat16),
                                    torch.zeros(1, 8, 8, co, dtype=torch.bfloat16), (1, 1))

    with pytest.raises(ValueError, match="CUDA tensors"):
        winograd.filterGradNHWC(torch.zeros(1, 8, 8, 128, dtype=torch.bfloat16),
                                torch.zeros(1, 8, 8, 128, dtype=torch.bfloat16), (1, 1))


# the smallest case (4 tiles, one step of less than one k16 block); odd OH
# and OW at pad 0; C != CO both ways; steps of 2 rows of 13 tiles, none full
# (26 of 32); rows of 33 tiles in runs of 17 and 16; pad 2; the ImageNet
# NiN's conv3 (12x12) and conv4-1024 (5x5, ragged tiles) at batch 2
_FG_CARD_CASES = [(1, 128, 4, 4, 128, 1), (2, 128, 9, 7, 128, 0), (3, 256, 14, 14, 128, 1), (2, 128, 10, 12, 256, 1),
                  (4, 128, 30, 26, 256, 1), (1, 128, 70, 66, 128, 1), (2, 128, 5, 6, 128, 2),
                  (2, 256, 12, 12, 384, 1), (2, 384, 5, 5, 1024, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("n, c, h, w, co, p", _FG_CARD_CASES)
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
@pytest.mark.parametrize("n, c, h, w, co, p", [(2, 128, 9, 7, 128, 1), (3, 256, 14, 14, 128, 1), (2, 128, 6, 5, 256, 0),
                                               (2, 256, 12, 12, 384, 1), (2, 384, 5, 5, 1024, 1)])
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


def _stepTiles(n, th, tw, step):
    """The tiles (image, tile row, tile column) of one of K3's steps, cut as
    the kernel cuts them (``winograd._stepGeometry``), in the order of the
    step's K axis: ``runs`` tile rows of ``length`` tiles from ``step``'s
    first row and column."""
    from puzzlelib_tpu_torch.ops.hopper import winograd

    length, runs, segs, _ = winograd._stepGeometry(n, th, tw)
    row0, j0 = step // segs * runs, step % segs * length

    return [(row // th, row % th, j) for row in range(row0, min(row0 + runs, n * th))
            for j in range(j0, min(j0 + length, tw))]


# VGG-16's six Winograd shapes at batch 32 (as K3 sees them: N, C, OH, OW, CO)
# and ragged ones: odd sizes, rows longer than a step, one image of one tile
_CHUNK_SHAPES = [(32, 128, 112, 112, 128), (32, 128, 56, 56, 256), (32, 256, 56, 56, 256), (32, 256, 28, 28, 512),
                 (32, 512, 28, 28, 512), (32, 512, 14, 14, 512), (3, 128, 9, 7, 256), (1, 128, 1, 1, 128),
                 (5, 256, 131, 67, 128), (2, 128, 3, 130, 128), (4096, 128, 2, 2, 128)]


@pytest.mark.parametrize("n, c, oh, ow, co", _CHUNK_SHAPES)
@pytest.mark.parametrize("sms", [132, 7])
def testTileChunkSplitsCoverEveryTileOnce(n, c, oh, ow, co, sms):
    """Each split of ``_tileChunk`` is a run of whole steps; the splits cover
    every tile exactly once, no step holds more than FG_KT tiles or more
    than FG_RMAX rows, and the grid stays within its 65,535 splits."""
    from puzzlelib_tpu_torch.ops.hopper import winograd

    th, tw = -(-oh // 2), -(-ow // 2)
    length, runs, segs, steps = winograd._stepGeometry(n, th, tw)
    chunk = winograd._tileChunk(steps, c, co, sms)
    splits = -(-steps // chunk)

    assert 1 <= splits <= 65535 and chunk >= 1 and runs * length <= winograd.FG_KT and runs <= winograd.FG_RMAX

    seen = np.zeros((n, th, tw), np.int64)
    for split in range(splits):
        for step in range(split * chunk, min((split + 1) * chunk, steps)):
            tiles = _stepTiles(n, th, tw, step)
            assert 1 <= len(tiles) <= winograd.FG_KT
            for tile in tiles:
                seen[tile] += 1

    assert (seen == 1).all()


def _xRows(xi):
    """B^T's row xi: its two nonzero patch rows (first, second) and whether
    they add (else the first less the second)."""
    return {0: (0, 2, False), 1: (1, 2, True), 2: (2, 1, False), 3: (1, 3, False)}[xi]


# A^T's column xi: its nonzero rows and signs (the reference's _ACOL)
_ACOL = {0: ((0, 1), ), 1: ((0, 1), (1, 1)), 2: ((0, 1), (1, -1)), 3: ((1, -1), )}


def _kernelOperands(x, dy, pad, xi):
    """What one of K3's blocks for ``xi`` computes, by the kernel's recipe,
    in bf16 (each torch op on bf16 rounds as the kernel's packed adds do):
    the x rows of B^T's row xi give t1 of the patch's four columns; V[xi nu]
    is t1 of nu's two columns (nu 0, 1 from columns 0-2, nu 2, 3 from
    columns 1-3); Mbar[xi nu] adds the dY terms of A^T's columns xi (outer)
    and nu (inner) in order.  Returns V (4, n, c, th, tw) and Mbar
    (4, n, co, th, tw)."""
    n, co, oh, ow = dy.shape
    h, w = x.shape[2:]
    th, tw = -(-oh // 2), -(-ow // 2)

    # the patches as the kernel's zero-filled loads see them
    xp = torch.nn.functional.pad(x, (pad[1], 2 * tw + 2 - w - pad[1], pad[0], 2 * th + 2 - h - pad[0]))
    d = xp.unfold(2, 4, 2).unfold(3, 4, 2)   # (n, c, th, tw, 4 rows, 4 columns)

    first, second, plus = _xRows(xi)
    t1 = [d[..., first, b] + d[..., second, b] if plus else d[..., first, b] - d[..., second, b] for b in range(4)]
    v = [t1[0] - t1[2], t1[1] + t1[2], t1[2] - t1[1], t1[1] - t1[3]]

    g = torch.nn.functional.pad(dy, (0, 2 * tw - ow, 0, 2 * th - oh)).reshape(n, co, th, 2, tw, 2)
    mbar = []
    for nu in range(4):
        m = None
        for a, sa in _ACOL[xi]:
            for b, sb in _ACOL[nu]:
                term = g[:, :, :, a, :, b]
                if m is None:
                    m = term if sa * sb > 0 else -term
                else:
                    m = m + term if sa * sb > 0 else m - term
        mbar.append(m)

    return torch.stack(v), torch.stack(mbar)


@pytest.mark.parametrize("n, c, h, w, co, p", [(2, 16, 9, 7, 24, 0), (1, 8, 8, 10, 8, 1), (3, 8, 5, 6, 16, 2)])
def testKernelOperandRecipeRebuildsPlainOperands(n, c, h, w, co, p):
    """The operands one xi's block builds (the x rows and dY entries it
    reads, the order of its bf16 adds) are bit for bit the V and Mbar of
    ``filterGradPlain``, for every xi: splitting the 16 products by xi
    changes no rounding."""
    from puzzlelib_tpu_torch.ops.hopper import winograd

    x, dy = _inputs(13, n, c, h, w, co, p)
    x, dy = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(dy).to(torch.bfloat16)
    oh, ow = dy.shape[2:]
    th, tw = -(-oh // 2), -(-ow // 2)

    vPlain = winograd._inputTransform(x, (p, p), th, tw)   # (n, c, th, tw, 4, 4)
    mPlain = winograd._gradTransform(dy, th, tw)           # (4, 4, n, co, th, tw)

    for xi in range(4):
        v, m = _kernelOperands(x, dy, (p, p), xi)
        assert torch.equal(v.float(), vPlain[..., xi, :].permute(4, 0, 1, 2, 3))
        assert torch.equal(m, mPlain[xi])


@pytest.mark.cuda
def testStepGeometryMatchesTheKernel():
    """The wrapper's step rule is the kernel's (``pl_winograd_fg_steps``)."""
    _cuda()
    import ctypes

    from puzzlelib_tpu_torch.ops.hopper import build, winograd

    fn = build.load("winograd_fg").pl_winograd_fg_steps
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = None

    for n, th, tw in [(32, 56, 56), (32, 28, 28), (32, 14, 14), (32, 7, 7), (3, 5, 3), (1, 1, 1), (5, 66, 34),
                      (2, 2, 65), (7, 9, 32), (4, 15, 13)]:
        out = [ctypes.c_int() for _ in range(4)]
        fn(n, th, tw, *[ctypes.byref(o) for o in out])
        assert tuple(o.value for o in out) == winograd._stepGeometry(n, th, tw)
