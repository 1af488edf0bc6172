"""The measurement probes P1-P3 (``ops/hopper/{tapdot,phasesplit,streamcopy}``)
against the Pallas kernels of the repo-root ``tools/*_probe.py`` in interpret
mode, the wrappers' refusals, and card-only cases of the CUDA kernels.

The repo-root ``tools/`` is no package, so each probe file is loaded from its
path.  P1 and P3 agree with the TPU kernels' statements; P2 is a copy and
agrees exactly.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch.ops.hopper import phasesplit, streamcopy, tapdot


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probe(name):
    """The repo-root ``tools/<name>.py`` as a module; skips where JAX does
    not import, as on the card's machine."""
    pytest.importorskip("jax.experimental.pallas", reason="the twins need JAX's Pallas")
    spec = importlib.util.spec_from_file_location("_probe_" + name, os.path.join(ROOT, "tools", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _needsCard():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ built with nvcc")


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _relMax(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- P1: the tap-dot conv --------------------------------------------------------------

# (n, c, h, w, co, k, pad, bi): the probe's --interpret shapes, with the
# probe's own bi, the first with a ragged bi (2 tiles of 8 rows for 12), and
# C = 48 and CO = 80, off the wgmma kernel's 64-channel chunk and 128-column
# block
TAPDOT_CASES = [(2, 128, 12, 10, 128, 3, 1, None), (1, 128, 9, 9, 128, 5, 2, None), (2, 128, 12, 10, 128, 3, 1, 8),
                (2, 48, 12, 10, 80, 3, 1, None)]


@pytest.mark.parametrize("dtype, bound", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("case", TAPDOT_CASES, ids=["k3", "k5", "ragged-bi", "c48-co80"])
def testTapdotConvTwin(case, dtype, bound):
    """``tapdot.conv2d`` (its plain version on the CPU) against the probe's
    ``conv2d(..., interpret=True)`` on the same inputs: f32 within 1e-5 of
    max |ref| (summation order), bf16 within 1e-2 (one rounding of an f32
    sum, 2^-9 of the value, in both)."""
    import jax.numpy as jnp

    probe = _probe("tapdot_probe")
    n, c, h, w, co, k, p, bi = case

    rng = np.random.RandomState(5)
    x = rng.randn(n, c, h, w).astype(np.float32)
    wt = (rng.randn(co, c, k, k) * 0.1).astype(np.float32)

    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(probe.conv2d(jnp.asarray(x).astype(jdt), jnp.asarray(wt).astype(jdt), (p, p), bi=bi,
                                   interpret=True)).astype(np.float32)

    tdt = getattr(torch, dtype)
    got = tapdot.conv2d(torch.from_numpy(x).to(tdt), torch.from_numpy(wt).to(tdt), (p, p), bi=bi).float().numpy()

    assert got.shape == want.shape == (n, co, h + 2 * p - k + 1, w + 2 * p - k + 1)
    assert _relMax(got, want) <= bound


def testTapdotPickBiAsTheProbe():
    """The tile rows the probe picks, at its shapes and VGG-16's."""
    for oh, wp in ((12, 12), (9, 13), (56, 58), (28, 30), (112, 114), (14, 16)):
        bi = tapdot.pickBi(oh, wp)
        assert (bi * wp) % 8 == 0 and bi >= 8
    assert tapdot.pickBi(56, 58) == 8 and tapdot.pickBi(12, 12) == 12


def testTapdotRefusesUnknownPaths():
    """``_launch`` names its kernels; any other path is refused before a
    launch."""
    xp, wk = torch.zeros((1, 64, 16)), torch.zeros((9, 16, 16))
    before = tapdot.launches
    with pytest.raises(ValueError, match="paths"):
        tapdot._launch(xp, wk, 1, 8, 3, 3, 16, 16, 1, "wmma")
    assert tapdot.launches == before


def testTapdotPlainIsTheShiftedProducts():
    """``plain`` on a pitch layout equals the direct conv in f64 after the
    crop, and every garbage column stays out of the crop."""
    x = torch.randn(2, 16, 7, 5, dtype=torch.float64).float()
    w = torch.randn(32, 16, 3, 3, dtype=torch.float64).float()

    got = tapdot.conv2d(x, w, (1, 1))
    want = torch.nn.functional.conv2d(x.double(), w.double(), padding=1)
    assert got.shape == want.shape
    assert (got.double() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


# -- P2: the phase-slab copy ------------------------------------------------------------

@pytest.mark.parametrize("shape, rows", [((1, 16, 16, 128), 4), ((2, 8, 12, 128), 2)])
def testPhaseSplitTwin(monkeypatch, shape, rows):
    """``phaseSplit``'s plain version against the probe's ``phaseSplit`` with
    its ``pallas_call`` in interpret mode, exactly, batch 0 only."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    probe = _probe("strided_dma_probe")
    monkeypatch.setattr(probe.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))

    n, h, w, c = shape
    x = np.random.RandomState(6).randn(*shape).astype(np.float32)
    geometry = dict(rows=rows, tw=w // 2, c=c, nTiles=(h // 2) // rows)

    want = np.asarray(probe.phaseSplit(jnp.asarray(x).astype(jnp.bfloat16).reshape(n, h // 2, 2, w // 2, 2, c),
                                       **geometry)).astype(np.float32)
    got = phasesplit.phaseSplit(torch.from_numpy(x).to(torch.bfloat16).reshape(n, h // 2, 2, w // 2, 2, c),
                                **geometry)

    assert tuple(got.shape) == want.shape
    assert np.array_equal(got.float().numpy(), want)


def testPhaseSplitRefusesTooManyRows():
    x6 = torch.zeros(1, 4, 2, 4, 2, 8)
    with pytest.raises(ValueError, match="copies 3 tiles of 2 rows"):
        phasesplit.phaseSplit(x6, 2, 4, 8, 3)

    with pytest.raises(ValueError, match="phaseSplit takes x6"):
        phasesplit.phaseSplit(x6, 2, 4, 16, 1)


# -- P3: the streaming x + 1 -------------------------------------------------------------

def testAddOneTwin():
    """``addOne``'s plain version against a ``pallas_call`` of the roofline
    probe's ``copyKernel`` body and BlockSpecs (``roofline_probe.py:73-84``;
    the function is nested in its ``main``), at small blocks in interpret
    mode: bit for bit in bf16."""
    pytest.importorskip("jax.experimental.pallas", reason="the twin needs JAX's Pallas")
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    rows, blk = 64, 16

    def copyKernel(xr, yr):
        yr[...] = xr[...] + jnp.bfloat16(1)

    x = (np.random.RandomState(7).randn(rows, 512) * 4).astype(np.float32)
    want = pl.pallas_call(
        copyKernel,
        grid=(rows // blk, ),
        in_specs=[pl.BlockSpec((blk, 512), lambda r: (r, 0))],
        out_specs=pl.BlockSpec((blk, 512), lambda r: (r, 0)),
        out_shape=jax.ShapeDtypeStruct((rows, 512), jnp.bfloat16),
        interpret=True,
    )(jnp.asarray(x).astype(jnp.bfloat16))

    got = streamcopy.addOne(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def testAddOnePlainIsTheRoundedSum(dtype):
    x = torch.randn(1000, dtype=torch.float32).to(dtype)
    assert torch.equal(streamcopy.addOne(x), (x.double() + 1).to(dtype))


# -- refusals ------------------------------------------------------------------------

def testWrappersRefuseOtherDevices():
    """A tensor on neither the CPU nor a card is refused, never run."""
    with pytest.raises(ValueError, match="CUDA or CPU"):
        streamcopy.addOne(torch.zeros(8, device="meta"))

    with pytest.raises(ValueError, match="CUDA or CPU"):
        phasesplit.phaseSplit(torch.zeros((1, 2, 2, 2, 2, 16), device="meta"), 1, 2, 16, 2)

    with pytest.raises(ValueError, match="CUDA or CPU"):
        tapdot.tapdot(torch.zeros((1, 64, 16), device="meta"), torch.zeros((9, 16, 16), device="meta"),
                      1, 8, 3, 3, 16, 16, 1)


def testWrappersRefuseBadOperands():
    with pytest.raises(TypeError, match="bf16, f16 or f32"):
        streamcopy.addOne(torch.zeros(8, dtype=torch.int32))

    xp, wk = torch.zeros((1, 20, 16)), torch.zeros((9, 16, 32))
    with pytest.raises(ValueError, match="reads 26 rows"):
        tapdot.tapdot(xp, wk, 1, 8, 3, 3, 16, 32, 1)

    with pytest.raises(ValueError, match="wk"):
        tapdot.tapdot(torch.zeros((1, 64, 16)), wk, 1, 8, 3, 3, 16, 16, 1)

    with pytest.raises(TypeError, match="one type"):
        tapdot.tapdot(torch.zeros((1, 64, 16)), wk.to(torch.bfloat16), 1, 8, 3, 3, 16, 32, 1)


# -- on the card -------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def testAddOneOnCard(dtype):
    _needsCard()
    x = torch.randn(1 << 20, device="cuda").to(dtype)
    before = streamcopy.launches

    for length in (x.numel(), 1001, 7):
        assert torch.equal(streamcopy.addOne(x[:length]), streamcopy.plain(x[:length]))

    assert streamcopy.launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("shape, rows", [((1, 64, 64, 256), 4), ((1, 224, 224, 64), 4), ((2, 16, 16, 24), 2),
                                         ((1, 14, 20, 8), 3)])
def testPhaseSplitOnCard(shape, rows):
    """Exact at the probe's shapes, at rows of 48 and 16 bytes, and with
    rows left over past the last tile."""
    _needsCard()
    n, h, w, c = shape
    x6 = torch.randn(shape, device="cuda").to(torch.bfloat16).reshape(n, h // 2, 2, w // 2, 2, c)
    geometry = dict(rows=rows, tw=w // 2, c=c, nTiles=(h // 2) // rows)

    before = phasesplit.launches
    assert torch.equal(phasesplit.phaseSplit(x6, **geometry), phasesplit.plain(x6, **geometry))
    assert phasesplit.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("xshape, co, dtype", [((2, 64, 20, 18), 32, torch.bfloat16),
                                               ((3, 48, 13, 11), 80, torch.float16),
                                               ((1, 32, 30, 7), 16, torch.bfloat16)])
def testTapdotOnCard(xshape, co, dtype):
    """The kernel within 5e-3 relative L2 of its plain version (f32 sums of
    the same products in another order, one rounding), ragged rows and
    channels included."""
    _needsCard()
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = (torch.randn(xshape, generator=gen, device="cuda") * 0.3).to(dtype)
    w = (torch.randn((co, xshape[1], 3, 3), generator=gen, device="cuda") * 0.1).to(dtype)
    xp, wk, geometry, _ = tapdot.layout(x, w, (1, 1))

    before = tapdot.launches
    got, ref = tapdot.tapdot(xp, wk, **geometry), tapdot.plain(xp, wk, **geometry)
    assert tapdot.launches == before + 1
    assert ((got.float() - ref.float()).norm() / ref.float().norm()).item() <= 5e-3


@pytest.mark.cuda
def testPhaseSplitRefusesRaggedRowsOnCard():
    """A C-value row of 6 bytes is no whole number of the kernel's 16-byte
    units: refused before a launch."""
    _needsCard()
    before = phasesplit.launches
    with pytest.raises(ValueError, match="16-byte units"):
        phasesplit.phaseSplit(torch.zeros((1, 4, 2, 4, 2, 3), device="cuda").to(torch.bfloat16), 2, 4, 3, 2)
    assert phasesplit.launches == before


@pytest.mark.cuda
def testTapdotRefusalsOnCard():
    """f32 and channels off the multiple of 16 are refused before a launch;
    a slab too tall for shared memory is refused by the launch and raises."""
    _needsCard()
    wk = torch.zeros((9, 16, 16), device="cuda")
    with pytest.raises(TypeError, match="bf16 or f16"):
        tapdot.tapdot(torch.zeros((1, 64, 16), device="cuda"), wk, 1, 8, 3, 3, 16, 16, 1)

    with pytest.raises(ValueError, match="multiples of 16"):
        tapdot.tapdot(torch.zeros((1, 64, 24), device="cuda").half(), torch.zeros((9, 24, 16), device="cuda").half(),
                      1, 8, 3, 3, 24, 16, 1)

    wp = 3000
    xp = torch.zeros((1, wp + 2 * wp + 2, 16), device="cuda").half()
    before = tapdot.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        tapdot.tapdot(xp, wk.half(), 1, wp, 3, 3, 16, 16, 1)
    assert tapdot.launches == before


def _tapdotOperands(xshape, co, k, pad, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(xshape, generator=gen, device="cuda") * 0.3).to(dtype)
    w = (torch.randn((co, xshape[1], k, k), generator=gen, device="cuda") * 0.1).to(dtype)
    return tapdot.layout(x, w, (pad, pad))


def _relL2(got, ref):
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("channel", [5, 101])
def testTapdotShiftedDescriptorOnCard(channel):
    """The wgmma kernel's shifted A descriptor, one-hot: image i of xp is
    zeros with a single 1 at (row i, channel), wk an identity on that
    channel at one tap at a time and zeros elsewhere.  Output row g must
    read exactly 1 in that channel where g + r wp + s is row i, and 0
    everywhere else, for each of the 9 taps, at rows on both sides of 64,
    128 and 256 and of the block's 256 rows (C = CO = 128: the channel in the
    first or second 64-channel chunk and 64-column box)."""
    _needsCard()
    wp, bi, nTiles, c = 30, 10, 2, 128
    m = nTiles * bi * wp
    rows = [0, 63, 64, 127, 128, 255, 256, 257, 300, 511, 512, m + 2 * wp + 1]
    xp = torch.zeros((len(rows), m + 2 * wp + 2, c), device="cuda", dtype=torch.bfloat16)
    for i, row in enumerate(rows):
        xp[i, row, channel] = 1

    for tap in range(9):
        wk = torch.zeros((9, c, c), device="cuda", dtype=torch.bfloat16)
        wk[tap, channel, channel] = 1
        want = torch.zeros((len(rows), m, c), device="cuda", dtype=torch.bfloat16)
        for i, row in enumerate(rows):
            g = row - (tap // 3) * wp - tap % 3
            if 0 <= g < m:
                want[i, g, channel] = 1

        got = tapdot.tapdot(xp, wk, bi, wp, 3, 3, c, c, nTiles)
        assert torch.equal(got, want), "tap %d: ones at %s, want %s" % (
            tap, got.nonzero().tolist(), want.nonzero().tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("k, pad, width", [(5, 2, 110), (3, 1, 112)], ids=["5x5-chunk32", "3x3-chunk64"])
def testTapdotWgmmaEdgesOnCard(k, pad, width):
    """The wgmma kernel within 5e-3 relative L2 of its plain version at pitch
    114 (a slab of 486 or 716 rows, cut into TMA boxes across row 256), C 48
    and CO 80 (off the chunk and the 128-column block), f16, one image, and
    912 output rows (off a multiple of 256); the 5x5 slab takes 32-channel
    chunks, the 3x3 one 64."""
    _needsCard()
    xp, wk, geometry, _ = _tapdotOperands((1, 48, 7, width), 80, k, pad, torch.float16, 7)
    assert geometry["wp"] == 114 and geometry["nTiles"] * geometry["bi"] * geometry["wp"] == 912

    got, ref = tapdot.tapdot(xp, wk, **geometry), tapdot.plain(xp, wk, **geometry)
    assert _relL2(got, ref) <= 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("xshape, co, dtype", [((2, 64, 20, 18), 32, torch.bfloat16),
                                               ((3, 48, 13, 11), 80, torch.float16)])
def testTapdotYardstickOnCard(xshape, co, dtype):
    """The first mma.sync kernel, reached through ``_launch``, within 5e-3
    relative L2 of the plain version; it counts in ``launches`` and not in
    ``launchesWgmma``."""
    _needsCard()
    xp, wk, geometry, _ = _tapdotOperands(xshape, co, 3, 1, dtype, 9)

    before, beforeWgmma = tapdot.launches, tapdot.launchesWgmma
    got = tapdot._launch(xp, wk, **geometry, path="mma")
    assert (tapdot.launches, tapdot.launchesWgmma) == (before + 1, beforeWgmma)
    assert _relL2(got, tapdot.plain(xp, wk, **geometry)) <= 5e-3


@pytest.mark.cuda
def testTapdotTakesWgmmaOnCard():
    """``tapdot`` on CUDA tensors launches the wgmma kernel: both counters
    move by one."""
    _needsCard()
    xp, wk, geometry, _ = _tapdotOperands((2, 32, 9, 30), 48, 3, 1, torch.bfloat16, 11)

    before, beforeWgmma = tapdot.launches, tapdot.launchesWgmma
    got = tapdot.tapdot(xp, wk, **geometry)
    assert (tapdot.launches, tapdot.launchesWgmma) == (before + 1, beforeWgmma + 1)
    assert _relL2(got, tapdot.plain(xp, wk, **geometry)) <= 5e-3
