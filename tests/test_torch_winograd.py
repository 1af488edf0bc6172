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


@pytest.mark.cuda
@pytest.mark.parametrize("n, c, h, w, co, p", [(2, 128, 9, 7, 128, 0), (1, 32, 12, 10, 64, 1), (3, 256, 14, 14, 128, 1),
                                               (2, 64, 5, 5, 192, 1)])
def testKernelMatchesPlainOnCard(n, c, h, w, co, p):
    """bf16 kernel against its plain version within 1e-2 of max|ref| (the
    chip_smoke.py bound), through the conv dispatch where it applies."""
    device = _cuda()
    from puzzlelib_tpu_torch.ops import conv as tconv
    from puzzlelib_tpu_torch.ops.hopper import winograd

    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((n, c, h, w), generator=gen, device=device).to(torch.bfloat16)
    wt = (torch.randn((co, c, 3, 3), generator=gen, device=device) * (2.0 / (9 * c)) ** 0.5).to(torch.bfloat16)

    before = winograd.launches
    got = winograd.conv2d(x, wt, (p, p))
    ref = winograd.plain(x, wt, (p, p))
    torch.cuda.synchronize()

    assert winograd.launches == before + 1
    assert ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item() <= 1e-2

    routed = tconv.convNd(x, wt, None, (1, 1), (p, p), (1, 1), 1)
    torch.cuda.synchronize()
    taken = winograd.applicable(tuple(x.shape), tuple(wt.shape), (1, 1), (p, p), (1, 1), 1)

    assert winograd.launches == before + 1 + int(taken)
    assert ((routed.float() - ref.float()).abs().max() / ref.float().abs().max()).item() <= 1e-2
