"""Kernel K2 (the port's fused Winograd F(2x2, 3x3) forward conv) against the
JAX package.

On the CPU the wrapper runs its plain PyTorch version, which is held to the
Pallas kernel in interpret mode (as tests/test_pallas.py runs it) and to the
reference's conv op.  The CUDA cases run only where a card is present.
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


def _inputs(seed, n, c, h, w, co):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c, h, w).astype(np.float32)
    wt = (rng.randn(co, c, 3, 3) * 0.1).astype(np.float32)
    return x, wt


@pytest.mark.parametrize("n, c, h, w, co, p", [(1, 128, 8, 8, 128, 1), (2, 128, 9, 7, 128, 0)])
def testPlainMatchesPallasInterpret(n, c, h, w, co, p):
    """f32 within 1e-4 of max|ref|: the same algorithm, f32 transforms and
    sums in another order (the odd 9 x 7 case crops a partial tile)."""
    jnp = _jnp()
    from puzzlelib_tpu.ops.pallas import winograd as jwino
    from puzzlelib_tpu_torch.ops.hopper import winograd

    x, wt = _inputs(7, n, c, h, w, co)
    want = np.asarray(jwino.conv2d(jnp.asarray(x), jnp.asarray(wt), (p, p), interpret=True))

    before = winograd.launches
    got = winograd.conv2d(torch.from_numpy(x), torch.from_numpy(wt), (p, p)).numpy()

    assert got.shape == want.shape == (n, co, h + 2 * p - 2, w + 2 * p - 2)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert winograd.launches == before


@pytest.mark.parametrize("n, c, h, w, co, p", [(2, 8, 7, 9, 4, 1), (1, 4, 6, 5, 6, 0), (3, 2, 3, 3, 2, 1)])
def testPlainMatchesReferenceConv(n, c, h, w, co, p):
    """The plain Winograd algorithm against the reference's direct conv op
    (``ops.conv.convNd``, XLA on the CPU), f32 within 1e-5 of max|ref|: the
    transforms add a few f32 roundings to each output."""
    jnp = _jnp()
    from puzzlelib_tpu.ops import conv as jconv
    from puzzlelib_tpu_torch.ops.hopper import winograd

    x, wt = _inputs(11, n, c, h, w, co)
    want = np.asarray(jconv.convNd(jnp.asarray(x), jnp.asarray(wt), None, (1, 1), (p, p), (1, 1), 1))
    got = winograd.plain(torch.from_numpy(x), torch.from_numpy(wt), (p, p)).numpy()

    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


_SHAPES = [
    ((32, 256, 56, 56), (256, 256, 3, 3), (1, 1), (1, 1), (1, 1), 1),
    ((32, 128, 112, 112), (128, 128, 3, 3), (1, 1), (1, 1), (1, 1), 1),
    ((32, 512, 14, 14), (512, 512, 3, 3), (1, 1), (1, 1), (1, 1), 1),
    ((2, 128, 9, 7), (128, 128, 3, 3), (1, 1), (0, 0), (1, 1), 1),
    ((32, 256, 56, 56), (256, 256, 3, 3), (2, 2), (1, 1), (1, 1), 1),
    ((32, 64, 56, 56), (64, 64, 3, 3), (1, 1), (1, 1), (1, 1), 1),
    ((32, 128, 56, 56), (64, 128, 3, 3), (1, 1), (1, 1), (1, 1), 1),
    ((32, 256, 56, 56), (256, 256, 5, 5), (1, 1), (2, 2), (1, 1), 1),
    ((32, 256, 56, 56), (256, 256, 3, 3), (1, 1), (1, 1), (2, 2), 1),
    ((32, 256, 56, 56), (256, 128, 3, 3), (1, 1), (1, 1), (1, 1), 2),
    ((1, 128, 3, 3), (128, 128, 3, 3), (1, 1), (0, 0), (1, 1), 1),
    ((1, 128, 4, 3), (128, 128, 3, 3), (1, 1), (0, 0), (1, 1), 1),
    ((1, 128, 4, 4), (128, 128, 3, 3), (1, 1), (0, 0), (1, 1), 1),
    ((1, 128, 2, 2), (128, 128, 3, 3), (1, 1), (1, 1), (1, 1), 1),
    ((1, 128, 5), (128, 128, 3), (1, ), (1, ), (1, ), 1),
]


@pytest.mark.parametrize("xshape, wshape, stride, pad, dilation, groups", _SHAPES)
def testApplicableMatchesReference(xshape, wshape, stride, pad, dilation, groups):
    """The port's rule is the reference's less its VMEM clause; none of these
    shapes hits that clause."""
    _jnp()
    from puzzlelib_tpu.ops.pallas import winograd as jwino
    from puzzlelib_tpu_torch.ops.hopper import winograd

    want = jwino.applicable(xshape, wshape, stride, pad, dilation, groups)
    assert winograd.applicable(xshape, wshape, stride, pad, dilation, groups) == want


def testFilterTransformMatchesReference():
    jnp = _jnp()
    from puzzlelib_tpu.ops.pallas import winograd as jwino
    from puzzlelib_tpu_torch.ops.hopper import winograd

    _, wt = _inputs(5, 1, 6, 3, 3, 4)
    want = np.asarray(jwino._filterTransform(jnp.asarray(wt)))
    got = winograd.filterTransform(torch.from_numpy(wt)).numpy()

    assert got.shape == want.shape == (16, 6, 4)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def testWrapperRejectsWhatTheKernelDoesNotTake():
    from puzzlelib_tpu_torch.ops.hopper import winograd

    with pytest.raises(ValueError):
        winograd.conv2d(torch.zeros(1, 4, 8, 8), torch.zeros(4, 4, 5, 5))

    with pytest.raises(ValueError):
        winograd.conv2d(torch.zeros(1, 4, 8, 8), torch.zeros(4, 3, 3, 3))

    with pytest.raises(ValueError):
        winograd.conv2d(torch.zeros(1, 4, 2, 2), torch.zeros(4, 4, 3, 3), (0, 0))

    with pytest.raises(ValueError):
        winograd.conv2dNHWC(torch.zeros(1, 8, 8, 32, dtype=torch.bfloat16),
                            torch.zeros(16, 32, 64, dtype=torch.bfloat16), (1, 1))

    # K2 takes C a multiple of 32 and CO of 128 (applicable admits multiples
    # of 128 of both); the channel rule is checked before the device
    for c, co in ((16, 128), (32, 64), (128, 192), (48, 256)):
        with pytest.raises(ValueError, match="multiples of 32 and 128"):
            winograd.conv2dNHWC(torch.zeros(1, 8, 8, c, dtype=torch.bfloat16),
                                torch.zeros(16, c, co, dtype=torch.bfloat16), (1, 1))

    with pytest.raises(ValueError, match="CUDA tensors"):
        winograd.conv2dNHWC(torch.zeros(1, 8, 8, 32, dtype=torch.bfloat16),
                            torch.zeros(16, 32, 128, dtype=torch.bfloat16), (1, 1))


# The order in which csrc/winograd.cu sums: steps of 32 input channels
# (`BK`), in each the passes over xi (`passXi`, winograd.cu:143), output
# column b's nu and their signs (the N_b of `nuSign`, winograd.cu:141), and
# A^T's entries (`atEntry`, winograd.cu:142), the signs with which a product
# of xi goes into output rows 0 and 1
_BK = 32
_XI_ORDER = (0, 3, 1, 2)
_NU = ((0, 1, 2), (1, 2, 3))
_NU_SIGN = ((1, 1, 1), (1, -1, -1))
_AT = ((1, 1, 1, 0), (0, 1, -1, -1))


def _kernelSchedule(x, w, pad):
    """K2's sums in the kernel's order, in plain torch: V and U as ``plain``
    makes them; for each step of ``_BK`` channels, xi of ``_XI_ORDER``,
    output column b and nu of N_b, the step's f32 product goes into Y[a, b]
    with sign A^T[a][xi] s_b(nu) for each a where A^T[a][xi] is not 0.  NCHW
    x, OIHW w -> NCHW in x's type."""
    from puzzlelib_tpu_torch.ops.hopper import winograd

    n, c, h, wd = x.shape
    co = w.shape[0]
    oh, ow = h + 2 * pad[0] - 2, wd + 2 * pad[1] - 2
    th, tw = -(-oh // 2), -(-ow // 2)

    v = winograd._inputTransform(x, pad, th, tw)   # (n, c, th, tw, 4, 4) f32
    u = winograd.filterTransform(w).float().reshape(4, 4, c, co)

    y = [[None, None], [None, None]]
    for c0 in range(0, c, _BK):
        for xi in _XI_ORDER:
            for b in range(2):
                for nu, sign in zip(_NU[b], _NU_SIGN[b]):
                    product = torch.einsum("nchw,co->nohw", v[:, c0:c0 + _BK, ..., xi, nu], u[xi, nu, c0:c0 + _BK])
                    for a in range(2):
                        if _AT[a][xi] != 0:
                            term = (_AT[a][xi] * sign) * product
                            y[a][b] = term if y[a][b] is None else y[a][b] + term

    out = torch.stack([torch.stack(row, -1) for row in y], 3)   # (n, co, th, 2, tw, 2)
    return out.reshape(n, co, 2 * th, 2 * tw)[:, :, :oh, :ow].to(x.dtype)


@pytest.mark.parametrize("n, c, h, w, co, p", [(2, 8, 7, 9, 4, 1), (1, 64, 9, 6, 8, 0)])
def testKernelScheduleMatchesPlain(n, c, h, w, co, p):
    """The kernel's order of sums (36 signed products a tile, straight into
    the two rows of Y) is the algorithm of ``plain``: f32 within 1e-6 of
    max|ref|, so a wrong sign or a wrong nu set fails here."""
    from puzzlelib_tpu_torch.ops.hopper import winograd

    x, wt = _inputs(17, n, c, h, w, co)
    x, wt = torch.from_numpy(x), torch.from_numpy(wt)
    got, want = _kernelSchedule(x, wt, (p, p)), winograd.plain(x, wt, (p, p))

    assert got.shape == want.shape == (n, co, h + 2 * p - 2, w + 2 * p - 2)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-6


@pytest.mark.parametrize("n, c, h, w, co, p", [(1, 128, 8, 8, 128, 1), (2, 128, 9, 7, 128, 0)])
def testKernelScheduleMatchesPallasInterpretBf16(n, c, h, w, co, p):
    """The kernel's order of sums on bf16 operands against the Pallas
    kernel's ``conv2dNHWC`` in interpret mode, within 1e-2 of max|ref|: the
    same rounding points (bf16 butterflies, bf16 U, f32 sums, one bf16
    rounding of y), the f32 sums in another order."""
    jnp = _jnp()
    from puzzlelib_tpu.ops.pallas import winograd as jwino

    x, wt = _inputs(19, n, c, h, w, co)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(wt).to(torch.bfloat16)
    want = np.asarray(jwino.conv2dNHWC(jnp.asarray(xb.float().numpy().transpose(0, 2, 3, 1), jnp.bfloat16),
                                       jnp.asarray(wb.float().numpy(), jnp.bfloat16), (p, p),
                                       interpret=True).astype(jnp.float32)).transpose(0, 3, 1, 2)
    got = _kernelSchedule(xb, wb, (p, p)).float().numpy()

    assert got.shape == want.shape == (n, co, h + 2 * p - 2, w + 2 * p - 2)
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


# odd OH and OW at pad 0; pads 1 and 2; C != CO both ways; rows of 3 tiles,
# 8 to a block, over 15 rows of 5 images (the last block 7 rows); rows of 28
# tiles, 2 to a block, over 7 rows (the last block one); rows of 75 tiles in
# runs of 38 and 37; VGG-16's conv5 shape at batch 3; the ImageNet NiN's
# conv3 (12x12) and conv4-1024 (5x5: 3x3 tiles, the last row and column
# ragged) at batch 2
_CARD_CASES = [(2, 128, 9, 7, 128, 0), (1, 32, 12, 10, 128, 1), (2, 64, 11, 13, 256, 2), (1, 256, 10, 10, 128, 1),
               (2, 32, 12, 10, 256, 1), (5, 64, 6, 6, 128, 1), (1, 32, 14, 56, 128, 1), (1, 32, 6, 150, 128, 1),
               (3, 512, 14, 14, 512, 1), (2, 256, 12, 12, 384, 1), (2, 384, 5, 5, 1024, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("n, c, h, w, co, p", _CARD_CASES)
def testKernelMatchesPlainOnCard(n, c, h, w, co, p):
    """bf16 kernel against its plain version within 1e-2 of max|ref| (the
    chip_smoke.py bound), the same bits on a second call, and the conv
    dispatch through it where it applies."""
    device = _cuda()
    from puzzlelib_tpu_torch.ops import conv as tconv
    from puzzlelib_tpu_torch.ops.hopper import winograd

    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((n, c, h, w), generator=gen, device=device).to(torch.bfloat16)
    wt = (torch.randn((co, c, 3, 3), generator=gen, device=device) * (2.0 / (9 * c)) ** 0.5).to(torch.bfloat16)

    before = winograd.launches
    got, again = winograd.conv2d(x, wt, (p, p)), winograd.conv2d(x, wt, (p, p))
    ref = winograd.plain(x, wt, (p, p))
    torch.cuda.synchronize()

    assert winograd.launches == before + 2 and torch.equal(got, again)
    assert ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item() <= 1e-2

    routed = tconv.convNd(x, wt, None, (1, 1), (p, p), (1, 1), 1)
    torch.cuda.synchronize()
    taken = winograd.applicable(tuple(x.shape), tuple(wt.shape), (1, 1), (p, p), (1, 1), 1)

    assert winograd.launches == before + 2 + int(taken)
    assert ((routed.float() - ref.float()).abs().max() / ref.float().abs().max()).item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("n, c, h, w, co, p", [(2, 128, 9, 7, 64, 0), (1, 256, 12, 10, 32, 1), (2, 128, 8, 11, 128, 2),
                                               (2, 256, 12, 12, 384, 1), (2, 384, 5, 5, 1024, 1)])
def testKernelDataGradMatchesPlainOnCard(n, c, h, w, co, p):
    """bf16 bwd-data through ``winograd.dataGrad`` (the kernel on dy, C = co,
    CO = c, at pad 2 - p) against the plain version within 1e-2 of max|ref|,
    counted as a bwd-data launch."""
    device = _cuda()
    from puzzlelib_tpu_torch.ops.hopper import winograd

    gen = torch.Generator(device=device).manual_seed(4)
    dy = torch.randn((n, co, h + 2 * p - 2, w + 2 * p - 2), generator=gen, device=device).to(torch.bfloat16)
    wt = (torch.randn((co, c, 3, 3), generator=gen, device=device) * (2.0 / (9 * co)) ** 0.5).to(torch.bfloat16)

    before = (winograd.launches, winograd.dataGradLaunches)
    got = winograd.dataGrad(dy, wt, (p, p))
    ref = winograd.plain(dy, wt.flip((2, 3)).transpose(0, 1), (2 - p, 2 - p))
    torch.cuda.synchronize()

    assert got.shape == ref.shape == (n, c, h, w)
    assert (winograd.launches, winograd.dataGradLaunches) == (before[0] + 1, before[1] + 1)
    assert ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item() <= 1e-2
