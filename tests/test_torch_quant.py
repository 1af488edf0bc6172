"""Kernel K1-int8 (the port's int8 -> int32 GEMM), the int8 primitives of
``ops/quant.py`` and the ``DataCalibrator``, against the JAX package.

On the CPU the GEMM wrappers (``matmul``, and ``matmulNT`` with the K-major
table B^T) run their plain versions, which are held exactly to the Pallas
kernel in interpret mode (as tests/test_pallas.py runs it); the quantized
Linear and conv, on the K-major tables the engine lays out, are held to the
reference's XLA int8 products, exactly for the int32 products and within
1e-6 relative for the dequantized outputs.  The CUDA cases run only where a
card is present.
"""

import numpy as np
import pytest
import torch


def _jax():
    """jax.numpy and lax for the twin tests.  They skip where the JAX package
    does not import, as on the card's machine, where only the CUDA cases
    run."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    import jax.numpy as jnp
    from jax import lax

    return jnp, lax


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


def _int8(rng, *shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("m, k, n, padded", [(256, 384, 256, False), (100, 200, 60, True)])
def testInt8PlainMatchesPallasInterpret(m, k, n, padded):
    """Exact: both accumulate int8 products in int32.  The aligned case runs
    ``matmul`` with 128 tiles, the ragged one ``matmulPadded`` (the int8
    granule is 32 rows)."""
    jnp, _ = _jax()
    from puzzlelib_tpu.ops.pallas.matmul import matmul as jmatmul, matmulPadded
    from puzzlelib_tpu_torch.ops.hopper import matmul

    rng = np.random.RandomState(2)
    a, b = _int8(rng, m, k), _int8(rng, k, n)

    run = matmulPadded if padded else jmatmul
    want = run(jnp.asarray(a), jnp.asarray(b), bm=128, bn=128, bk=128, interpret=True)
    assert want.dtype == jnp.int32

    before = (matmul.launches, matmul.launchesInt8)
    for got in (matmul.matmul(torch.from_numpy(a), torch.from_numpy(b)),
                matmul.matmulOp(torch.from_numpy(a), torch.from_numpy(b))):
        assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
        assert np.array_equal(got.numpy(), np.asarray(want))

    assert (matmul.launches, matmul.launchesInt8) == before   # the CPU takes the plain version


@pytest.mark.parametrize("m, k, n", [(100, 200, 60), (33, 27, 17), (130, 144, 72), (1, 32, 300)])
def testInt8PlainNTMatchesPallasInterpret(m, k, n):
    """``matmulNT`` (a @ bt^T with the (N, K) table) and its operator equal
    the Pallas kernel on the (K, N) matrix exactly, on ragged shapes
    (``matmulPadded``, the int8 granule of 32 rows)."""
    jnp, _ = _jax()
    from puzzlelib_tpu.ops.pallas.matmul import matmulPadded
    from puzzlelib_tpu_torch.ops.hopper import matmul

    rng = np.random.RandomState(13)
    a, bt = _int8(rng, m, k), _int8(rng, n, k)

    want = np.asarray(matmulPadded(jnp.asarray(a), jnp.asarray(np.ascontiguousarray(bt.T)), bm=128, bn=128, bk=128,
                                   interpret=True))

    before = (matmul.launchesInt8, matmul.launchesInt8Wgmma)
    for got in (matmul.matmulNT(torch.from_numpy(a), torch.from_numpy(bt)),
                matmul.matmulNTOp(torch.from_numpy(a), torch.from_numpy(bt))):
        assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
        assert np.array_equal(got.numpy(), want)

    assert (matmul.launchesInt8, matmul.launchesInt8Wgmma) == before   # the CPU takes the plain version


def testMatmulNTRejectsWhatTheKernelDoesNotTake():
    from puzzlelib_tpu_torch.ops.hopper import matmul

    with pytest.raises(ValueError):
        matmul.matmulNT(torch.zeros(4, 5, dtype=torch.int8), torch.zeros(5, 3, dtype=torch.int8))

    with pytest.raises(TypeError):
        matmul.matmulNT(torch.zeros(4, 5), torch.zeros(3, 5))

    with pytest.raises(TypeError):
        matmul.matmulNT(torch.zeros(4, 5, dtype=torch.int8), torch.zeros(3, 5, dtype=torch.int32))


def testInt8PlainDoesNotWrapAround():
    """``torch.matmul`` of two int8 tensors returns int8 on the CPU and wraps;
    the plain version gives the exact int32 sum, up to K * 127^2."""
    from puzzlelib_tpu_torch.ops.hopper import matmul

    a = torch.full((2, 4), 100, dtype=torch.int8)
    b = torch.full((4, 2), 100, dtype=torch.int8)
    assert torch.matmul(a, b).dtype == torch.int8

    assert torch.equal(matmul.plain(a, b), torch.full((2, 2), 40000, dtype=torch.int32))

    k = 25088
    a, b = torch.full((1, k), -127, dtype=torch.int8), torch.full((k, 1), -127, dtype=torch.int8)
    assert matmul.plain(a, b).item() == k * 127 ** 2


@pytest.mark.parametrize("shape, axis", [((6, 5), 1), ((6, 5), 0), ((4, 3, 3, 3), 0), ((8, 2, 3), 0)])
def testQuantizeWeightIsByteEqual(shape, axis):
    """Both packages quantize on the host with the same numpy statements; a
    channel of zeros takes the scale 1."""
    _jax()
    from puzzlelib_tpu.ops import quant as jquant
    from puzzlelib_tpu_torch.ops import quant

    w = np.random.RandomState(3).randn(*shape).astype(np.float32)
    w[(slice(None), ) * axis + (0, )] = 0.0

    wq, scale = quant.quantizeWeight(w, axis)
    jwq, jscale = jquant.quantizeWeight(w, axis)

    assert wq.dtype == np.int8 and scale.dtype == np.float32
    assert wq.tobytes() == jwq.tobytes() and scale.tobytes() == jscale.tobytes()


def _quantOperands(rng, wshape, axis):
    from puzzlelib_tpu_torch.ops import quant

    wq, wscale = quant.quantizeWeight((rng.randn(*wshape) * 0.2).astype(np.float32), axis)
    return wq, wscale.reshape(-1), np.float32(0.02)


@pytest.mark.parametrize("transpose, bias", [(False, True), (True, True), (False, False)])
def testQuantLinearTwin(transpose, bias):
    """The int32 products exactly (against ``lax.dot_general`` at
    ``preferred_element_type=int32``), the outputs within 1e-6 relative.  The
    reference takes a transposed Linear's (out, in) table as it is; the port
    takes the K-major (out, in) table an engine lays out once at build time
    (``linearOperand``)."""
    jnp, lax = _jax()
    from puzzlelib_tpu.ops import quant as jquant
    from puzzlelib_tpu_torch.ops import quant

    rng = np.random.RandomState(4)
    insize, outsize = 48, 24
    x = rng.randn(10, insize).astype(np.float32)
    wq, wscale, xscale = _quantOperands(rng, (outsize, insize) if transpose else (insize, outsize),
                                        0 if transpose else 1)
    b = rng.randn(outsize).astype(np.float32) if bias else None
    operand = quant.linearOperand(torch.from_numpy(wq), transpose)

    want = np.asarray(jquant.quantLinear(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(wscale), xscale,
                                         None if b is None else jnp.asarray(b), transpose=transpose))
    got = quant.quantLinear(torch.from_numpy(x), operand, torch.from_numpy(wscale), xscale,
                            None if b is None else torch.from_numpy(b)).numpy()

    xq = np.array(jquant._quantizeAct(jnp.asarray(x), xscale))
    assert np.array_equal(quant._quantizeAct(torch.from_numpy(x), xscale).numpy(), xq)

    jacc = lax.dot_general(jnp.asarray(xq), jnp.asarray(wq), (((1, ), (1 if transpose else 0, )), ((), ())),
                           preferred_element_type=jnp.int32)
    acc = quant.linearAcc(torch.from_numpy(xq), operand)
    assert np.array_equal(acc.numpy(), np.asarray(jacc))

    assert got.dtype == np.float32 and got.shape == want.shape == (10, outsize)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("transpose", [False, True])
def testQuantLinearTwinPadsK(transpose):
    """A Linear of 27 in-features, off a multiple of 16: its table is padded
    with zeros to 32 once (``linearOperand``), its quantized rows at each
    call, so its product is one that the route sends to ``wgmma`` with no
    per-call transpose; the int32 products equal ``lax.dot_general``'s
    exactly and the outputs the reference's within 1e-6 relative."""
    jnp, lax = _jax()
    from puzzlelib_tpu.ops import quant as jquant
    from puzzlelib_tpu_torch.ops import quant
    from puzzlelib_tpu_torch.ops.hopper import matmul

    rng = np.random.RandomState(17)
    insize, outsize = 27, 24
    x = rng.randn(10, insize).astype(np.float32)
    wq, wscale, xscale = _quantOperands(rng, (outsize, insize) if transpose else (insize, outsize),
                                        0 if transpose else 1)
    b = rng.randn(outsize).astype(np.float32)
    wt = quant.linearOperand(torch.from_numpy(wq), transpose)
    assert tuple(wt.shape) == (outsize, 32) and wt.is_contiguous() and not wt[:, insize:].any()
    assert matmul._route(10, outsize, wt.shape[1], torch.int8, True, 132) == "wgmma-64"

    want = np.asarray(jquant.quantLinear(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(wscale), xscale,
                                         jnp.asarray(b), transpose=transpose))
    got = quant.quantLinear(torch.from_numpy(x), wt, torch.from_numpy(wscale), xscale, torch.from_numpy(b)).numpy()

    xq = np.array(jquant._quantizeAct(jnp.asarray(x), xscale))
    jacc = lax.dot_general(jnp.asarray(xq), jnp.asarray(wq), (((1, ), (1 if transpose else 0, )), ((), ())),
                           preferred_element_type=jnp.int32)
    assert np.array_equal(quant.linearAcc(torch.from_numpy(xq), wt).numpy(), np.asarray(jacc))

    assert got.dtype == np.float32 and got.shape == want.shape == (10, outsize)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("transpose", [False, True])
def testLinearOperandGivesTheSameProducts(transpose):
    """The K-major (out, in) table, in padded with zeros to a multiple of
    16, gives the int32 products that the (in, out) table gave through
    ``matmul``, exactly."""
    from puzzlelib_tpu_torch.ops import quant

    rng = np.random.RandomState(14)
    insize, outsize = 40, 24
    wq = _int8(rng, outsize, insize) if transpose else _int8(rng, insize, outsize)
    x = torch.from_numpy(_int8(rng, 7, insize))
    old = torch.from_numpy(np.ascontiguousarray(wq.T if transpose else wq))   # (in, out)

    wt = quant.linearOperand(torch.from_numpy(wq), transpose)
    assert tuple(wt.shape) == (outsize, 48) and wt.is_contiguous()
    assert torch.equal(wt[:, :insize], old.t()) and not wt[:, insize:].any()
    assert torch.equal(quant.linearAcc(x, wt), quant._k1.matmul(x, old))


# (x shape, w shape, stride, pad, dilation, groups): strided, padded, dilated,
# grouped, all at once, the 1-d and 3-d convs, and conv1_1's three channels
# (K = 27, padded to 32)
_CONVS = [
    ((2, 6, 9, 9), (8, 6, 3, 3), (2, 2), (0, 0), (1, 1), 1),
    ((2, 6, 9, 9), (8, 6, 3, 3), (1, 1), (1, 2), (1, 1), 1),
    ((2, 6, 11, 10), (8, 6, 3, 3), (1, 1), (2, 2), (2, 2), 1),
    ((2, 6, 9, 9), (8, 3, 3, 3), (1, 1), (1, 1), (1, 1), 2),
    ((2, 8, 12, 11), (12, 2, 3, 2), (2, 1), (1, 2), (2, 1), 4),
    ((3, 4, 17), (5, 4, 5), (2, ), (2, ), (1, ), 1),
    ((1, 4, 6, 6, 6), (6, 2, 3, 3, 3), (1, 1, 1), (1, 1, 1), (1, 1, 1), 2),
    ((2, 3, 9, 9), (8, 3, 3, 3), (1, 1), (1, 1), (1, 1), 1),
]


@pytest.mark.parametrize("xshape, wshape, stride, pad, dilation, groups", _CONVS)
def testQuantConvNdTwin(xshape, wshape, stride, pad, dilation, groups):
    """The int32 products of the im2col route exactly (against
    ``lax.conv_general_dilated`` at ``preferred_element_type=int32``), the
    outputs within 1e-6 relative."""
    jnp, lax = _jax()
    from puzzlelib_tpu.ops import quant as jquant
    from puzzlelib_tpu_torch.ops import quant

    nd = len(xshape) - 2
    rng = np.random.RandomState(5)
    x = rng.randn(*xshape).astype(np.float32)
    wq, wscale, xscale = _quantOperands(rng, wshape, 0)
    b = rng.randn(1, wshape[0], *(1, ) * nd).astype(np.float32)
    wmat, ksize = quant.convOperand(torch.from_numpy(wq), groups), wshape[2:]

    want = np.asarray(jquant.quantConvNd(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(wscale), xscale,
                                         jnp.asarray(b), stride=stride, pad=pad, dilation=dilation, groups=groups))
    got = quant.quantConvNd(torch.from_numpy(x), wmat, ksize, torch.from_numpy(wscale), xscale,
                            torch.from_numpy(b), stride, pad, dilation).numpy()

    xq = jquant._quantizeAct(jnp.asarray(x), xscale)
    spatial = "DHW"[3 - nd:]
    jacc = np.asarray(lax.conv_general_dilated(
        xq, jnp.asarray(wq), window_strides=stride, padding=[(p, p) for p in pad], rhs_dilation=dilation,
        dimension_numbers=("NC" + spatial, "OI" + spatial, "NC" + spatial), feature_group_count=groups,
        preferred_element_type=jnp.int32))

    acc = quant.convAcc(torch.from_numpy(np.array(xq)), wmat, ksize, stride, pad, dilation)
    acc = acc.reshape((xshape[0], ) + jacc.shape[2:] + (wshape[0], )).movedim(-1, 1)
    assert acc.dtype == torch.int32 and np.array_equal(acc.numpy(), jacc)

    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("xshape, wshape, stride, pad, dilation, groups", _CONVS)
def testConvOperandGivesTheSameProducts(xshape, wshape, stride, pad, dilation, groups):
    """The K-major table (groups, O / groups, K padded to 16) holds the old
    (groups, K, O / groups) table transposed, then zeros, and ``convAcc``
    gives the int32 products that the old table gave through ``matmul`` on
    the unpadded im2col rows, exactly."""
    from puzzlelib_tpu_torch.ops import quant

    rng = np.random.RandomState(15)
    xq = torch.from_numpy(_int8(rng, *xshape))
    wq = torch.from_numpy(_int8(rng, *wshape))
    o, cg = wshape[:2]
    taps = int(np.prod(wshape[2:]))
    k = taps * cg

    old = wq.reshape(groups, o // groups, cg, taps).permute(0, 3, 2, 1).reshape(groups, k, o // groups)
    wmat = quant.convOperand(wq, groups)
    kpad = wmat.shape[2]

    assert tuple(wmat.shape[:2]) == (groups, o // groups) and kpad % 16 == 0 and k <= kpad < k + 16
    assert torch.equal(wmat[:, :, :k], old.transpose(1, 2)) and not wmat[:, :, k:].any()

    cols = quant.im2col(xq, wshape[2:], stride, pad, dilation)
    rows = cols.numel() // (taps * xshape[1])
    cols = cols.reshape(rows, taps, groups, cg)
    want = torch.cat([quant._k1.matmul(cols[:, :, g].reshape(rows, k).contiguous(), old[g].contiguous())
                      for g in range(groups)], dim=1)

    assert torch.equal(quant.convAcc(xq, wmat, wshape[2:], stride, pad, dilation), want)


# VGG-16's 13 convs: (input channels, output channels), 3x3 at pad 1
_VGG_CONVS = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256), (256, 256), (256, 512),
              (512, 512), (512, 512), (512, 512), (512, 512), (512, 512)]


def testEveryVggConvProductTakesWgmma(monkeypatch):
    """Each of VGG-16's 13 int8 conv products, conv1_1's K = 27 padded to
    32, is one that the route sends to K1-int8 on ``wgmma`` (K a multiple of
    16, 16-byte bases), and the padded products equal
    ``lax.conv_general_dilated``'s int32 sums exactly (at 6 x 6 inputs)."""
    jnp, lax = _jax()
    from puzzlelib_tpu_torch.ops import quant
    from puzzlelib_tpu_torch.ops.hopper import matmul

    products = []
    original = matmul.matmulNT

    def recording(a, bt):
        aligned = a.data_ptr() % 16 == 0 and bt.data_ptr() % 16 == 0
        products.append(matmul._route(a.shape[0], bt.shape[0], a.shape[1], a.dtype, aligned, 132))
        return original(a, bt)

    monkeypatch.setattr(matmul, "matmulNT", recording)

    rng = np.random.RandomState(16)
    for c, o in _VGG_CONVS:
        xq, wq = _int8(rng, 2, c, 6, 6), _int8(rng, o, c, 3, 3)
        wmat = quant.convOperand(torch.from_numpy(wq), 1)
        assert wmat.shape[2] == (32 if c == 3 else 9 * c)

        got = quant.convAcc(torch.from_numpy(xq), wmat, (3, 3), (1, 1), (1, 1), (1, 1))
        want = np.asarray(lax.conv_general_dilated(
            jnp.asarray(xq), jnp.asarray(wq), window_strides=(1, 1), padding=[(1, 1), (1, 1)],
            dimension_numbers=("NCHW", "OIHW", "NCHW"), preferred_element_type=jnp.int32))
        assert np.array_equal(got.reshape(2, 6, 6, o).permute(0, 3, 1, 2).numpy(), want)

    assert products == ["wgmma-128"] * 13


def _narrowNets():
    """The same narrow conv net in both packages, the JAX weights carried into
    the port: (jax net, port net)."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    from puzzlelib_tpu import containers as JC, modules as J
    from puzzlelib_tpu_torch import containers as TC, modules as T
    from puzzlelib_tpu_torch.convert import paramsFromNumpy

    def build(M, C, initscheme):
        net = C.Sequential(name="calib")
        net.append(M.Conv2D(3, 8, 3, pad=1, initscheme=initscheme, name="conv1"))
        net.append(M.Activation(M.relu, name="relu1"))
        net.append(M.MaxPool2D(2, 2, name="pool1"))
        net.append(M.Conv2D(8, 8, 3, pad=1, initscheme=initscheme, name="conv2"))
        net.append(M.Activation(M.relu, name="relu2"))
        net.append(M.Flatten())
        net.append(M.Linear(8 * 4 * 4, 10, initscheme=initscheme, name="fc"))
        return net

    np.random.seed(6)
    jnet = build(J, JC, "he")
    tnet = build(T, TC, "none")
    paramsFromNumpy(tnet, {name: var.data.get() for var, names in jnet.getVarTable().items() for name in names})
    return jnet, tnet


def testCalibratorMinmaxTwin():
    """The minmax scales of every quantizable module within 1e-6 relative:
    the same weights and data, the activations f32 in both (convs summed in
    another order)."""
    from puzzlelib_tpu.converter.engine import DataCalibrator as JCalibrator
    from puzzlelib_tpu.converter.engine.buildengine import _quantizableModules as jmodules
    from puzzlelib_tpu_torch.converter.engine import DataCalibrator
    from puzzlelib_tpu_torch.converter.engine.buildengine import _quantizableModules

    jnet, tnet = _narrowNets()
    jnet.evalMode()
    tnet.evalMode()
    data = np.random.RandomState(7).randn(20, 3, 8, 8).astype(np.float32)

    jmods, tmods = jmodules(jnet), _quantizableModules(tnet)
    assert [m.name for m in tmods] == [m.name for m in jmods] == ["conv1", "conv2", "fc"]

    jscales = JCalibrator(data, batchsize=8, algo="minmax").calibrate(jnet, jmods)
    tscales = DataCalibrator(data, batchsize=8, algo="minmax").calibrate(tnet, tmods)

    for jm, tm in zip(jmods, tmods):
        want, got = jscales[id(jm)], tscales[id(tm)]
        assert isinstance(got, np.float32) and abs(got - want) <= 1e-6 * abs(want)

    assert "updateData" not in tmods[0].__dict__   # the hooks are gone


@pytest.mark.parametrize("kind", ["gaussian", "spike"])
def testEntropyThresholdTwin(kind):
    """The KL sweep picks the same threshold on a fixed histogram: a half
    Gaussian, and one with a spike at zero (the mass floor's case)."""
    _jax()
    from puzzlelib_tpu.converter.engine import DataCalibrator as JCalibrator
    from puzzlelib_tpu_torch.converter.engine import DataCalibrator

    rng = np.random.RandomState(8)
    values = np.abs(rng.randn(20000))
    if kind == "spike":
        values[:12000] = 0.0

    top = float(values.max())
    hist = np.histogram(values, bins=512, range=(0.0, top))[0].astype(np.float64)

    data = np.zeros((1, 1), np.float32)
    want = JCalibrator(data, bins=512)._entropyThreshold(hist, top)
    got = DataCalibrator(data, bins=512)._entropyThreshold(hist, top)

    assert got == want and 0 < got <= top


@pytest.mark.cuda
@pytest.mark.parametrize("m, k, n", [(100, 200, 60), (6272, 576, 64), (32, 4096, 1000), (33, 27, 17)])
def testInt8KernelExactOnCard(m, k, n):
    """K1-int8 equals its plain version exactly: ragged shapes (byte loads,
    conv1_1's K = 27), a conv shape (16-byte loads) and an fc shape (split-K
    with int32 partials); and ``matmulOp`` counts as one int8 launch."""
    device = _cuda()
    from puzzlelib_tpu_torch.ops.hopper import matmul

    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randint(-127, 128, (m, k), generator=gen, device=device, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=gen, device=device, dtype=torch.int8)

    before = (matmul.launches, matmul.launchesInt8)
    got = matmul.matmulOp(a, b)
    ref = matmul.plain(a, b)
    torch.cuda.synchronize()

    assert (matmul.launches, matmul.launchesInt8) == (before[0], before[1] + 1)
    assert got.dtype == torch.int32 and torch.equal(got, ref)


@pytest.mark.cuda
def testQuantConvOnCardMatchesCpu():
    """The int8 conv on the card (im2col in int8, K1-int8) gives the CPU's
    values bit for bit: exact products and the same f32 statements."""
    device = _cuda()
    from puzzlelib_tpu_torch.ops import quant

    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(2, 32, 14, 14).astype(np.float32))
    wq, wscale, xscale = _quantOperands(rng, (64, 32, 3, 3), 0)
    wmat, wscale = quant.convOperand(torch.from_numpy(wq), 1), torch.from_numpy(wscale)
    b = torch.from_numpy(rng.randn(64).astype(np.float32))

    want = quant.quantConvNd(x, wmat, (3, 3), wscale, xscale, b, (1, 1), (1, 1), (1, 1))
    got = quant.quantConvNd(x.to(device), wmat.to(device), (3, 3), wscale.to(device), xscale, b.to(device),
                            (1, 1), (1, 1), (1, 1))

    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def testInt8KernelBeyondOneGridOfRows():
    """A product of more rows than the WMMA kernel's grid's second axis holds
    in blocks (64 * 65535), as an int8 engine's first conv gives beyond batch
    83, runs in one launch on wgmma (row tiles on the grid's first axis) and,
    with K off a multiple of 16, in two WMMA launches; both equal the plain
    version exactly; so does a narrow int8 conv at batch 86 of 224 x 224
    (4,315,136 output rows) against the CPU."""
    device = _cuda()
    from puzzlelib_tpu_torch.ops import quant
    from puzzlelib_tpu_torch.ops.hopper import matmul

    m, n = 64 * 65535 + 100, 16
    gen = torch.Generator(device=device).manual_seed(1)
    for k, launches, onWgmma in ((32, 1, 1), (24, 2, 0)):
        a = torch.randint(-127, 128, (m, k), generator=gen, device=device, dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=gen, device=device, dtype=torch.int8)

        before = (matmul.launchesInt8, matmul.launchesInt8Wgmma)
        got = matmul.matmul(a, b)
        assert (matmul.launchesInt8 - before[0], matmul.launchesInt8Wgmma - before[1]) == (launches, onWgmma)
        assert torch.equal(got, matmul.plain(a, b))
        del a, got

    rng = np.random.RandomState(12)
    x = torch.from_numpy(rng.randn(86, 3, 224, 224).astype(np.float32))
    wq, wscale, xscale = _quantOperands(rng, (8, 3, 3, 3), 0)
    wmat, wscale = quant.convOperand(torch.from_numpy(wq), 1), torch.from_numpy(wscale)

    want = quant.quantConvNd(x, wmat, (3, 3), wscale, xscale, None, (1, 1), (1, 1), (1, 1))
    got = quant.quantConvNd(x.to(device), wmat.to(device), (3, 3), wscale.to(device), xscale, None,
                            (1, 1), (1, 1), (1, 1))

    assert torch.equal(got.cpu(), want)


def _cardInt8(device, seed, *shape):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=gen, device=device, dtype=torch.int8)


@pytest.mark.cuda
@pytest.mark.parametrize("m, n, path", [(64, 64, "wgmma-64"), (64, 128, "wgmma-64"), (128, 64, "wgmma-128"),
                                        (128, 128, "wgmma-128"), (128, 256, "wgmma-128")])
def testInt8WgmmaSingleTile(m, n, path):
    """One block, one stage of four k32 products, on every ring the route
    uses: a one-hot A picks columns of B^T and a one-hot B^T picks columns of
    A, so a wrong descriptor of either operand shows as a wrong row or
    column, exactly."""
    device = _cuda()
    from puzzlelib_tpu_torch.ops.hopper import matmul

    k = 128
    a, bt = _cardInt8(device, 0, m, k), _cardInt8(device, 1, n, k)
    assert matmul._route(m, n, k, torch.int8, True, 132) == path

    pick = torch.arange(m, device=device) * 5 % k
    onehot = torch.zeros((m, k), device=device, dtype=torch.int8)
    onehot[torch.arange(m, device=device), pick] = 1
    assert torch.equal(matmul.matmulNT(onehot, bt), bt[:, pick].t().int())

    pick = torch.arange(n, device=device) * 7 % k
    onehot = torch.zeros((n, k), device=device, dtype=torch.int8)
    onehot[torch.arange(n, device=device), pick] = 1
    assert torch.equal(matmul.matmulNT(a, onehot), a[:, pick].int())

    assert torch.equal(matmul.matmulNT(a, bt), matmul.plainNT(a, bt))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["wgmma-64", "wgmma-128"])
@pytest.mark.parametrize("m, k, n", [(1, 128, 64), (63, 16, 8), (65, 48, 17), (130, 144, 72), (130, 400, 200),
                                     (200, 272, 264), (130, 1040, 520), (65, 32, 1000)])
def testInt8WgmmaTileEdges(m, k, n, path):
    """Shapes that cross every tile edge: M of 1, 63, 65, 130 and 200, N
    below a block, odd and off every block width (up to two column blocks
    of 256 and beyond), K below and off a multiple of 128; on both block
    heights.  Exact, and every output written (a sentinel fill)."""
    device = _cuda()
    from puzzlelib_tpu_torch.ops.hopper import matmul

    a, bt = _cardInt8(device, 2, m, k), _cardInt8(device, 3, n, k)
    got = torch.full((m, n), -2 ** 31, device=device, dtype=torch.int32)
    before = matmul.launchesInt8Wgmma
    matmul._launch(a, bt, got, path)
    torch.cuda.synchronize()

    assert matmul.launchesInt8Wgmma == before + 1
    assert torch.equal(got, matmul.plainNT(a, bt))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 1000, 4096])
def testInt8WgmmaSplitK(n):
    """fc6's K = 25088 at M = 32: several slices of int32 partials, summed in
    order, exact, and the same bits from a second call."""
    device = _cuda()
    from puzzlelib_tpu_torch.ops.hopper import matmul

    m, k = 32, 25088
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splitsOf, _ = matmul._entries()
    assert splitsOf(m, n, k, matmul._DTYPES[torch.int8], matmul._PATHS["wgmma-64"], sms) > 1

    a, bt = _cardInt8(device, 4, m, k), _cardInt8(device, 5, n, k)
    got = matmul.matmulNT(a, bt)
    assert torch.equal(got, matmul.plainNT(a, bt))
    assert torch.equal(matmul.matmulNT(a, bt), got)


@pytest.mark.cuda
@pytest.mark.parametrize("m, k, n", [(12544, 576, 64), (12544, 1152, 128), (6272, 2304, 256), (1568, 4608, 512),
                                     (8, 256, 64)])
def testInt8WgmmaRepeatsBitForBit(m, k, n):
    """The engine's conv shapes at batch 4 (and a one-block product): exact,
    and the same bits twice."""
    device = _cuda()
    from puzzlelib_tpu_torch.ops.hopper import matmul

    a, bt = _cardInt8(device, 6, m, k), _cardInt8(device, 7, n, k)
    got = matmul.matmulNT(a, bt)
    assert torch.equal(got, matmul.plainNT(a, bt))
    assert torch.equal(matmul.matmulNT(a, bt), got)


@pytest.mark.cuda
@pytest.mark.parametrize("m, k, n, wgmma", [(64, 128, 512, True), (300, 32, 64, True), (33, 27, 17, False),
                                            (100, 200, 60, False)])
def testInt8RouteCounters(m, k, n, wgmma):
    """Every int8 launch counts in ``launchesInt8``, the wgmma ones also in
    ``launchesInt8Wgmma``, through ``matmul`` (B laid out as B^T at the
    call) and ``matmulNT`` (B^T laid out as B at the call for the WMMA
    kernel) alike; the float counters stay."""
    device = _cuda()
    from puzzlelib_tpu_torch.ops.hopper import matmul

    a, bt = _cardInt8(device, 8, m, k), _cardInt8(device, 9, n, k)
    b = bt.t().contiguous()
    for run in (lambda: matmul.matmul(a, b), lambda: matmul.matmulNT(a, bt)):
        before = (matmul.launches, matmul.launchesWgmma, matmul.launchesInt8, matmul.launchesInt8Wgmma)
        got = run()
        after = (matmul.launches, matmul.launchesWgmma, matmul.launchesInt8, matmul.launchesInt8Wgmma)

        assert tuple(y - x for x, y in zip(before, after)) == (0, 0, 1, int(wgmma))
        assert torch.equal(got, matmul.plainNT(a, bt))


@pytest.mark.cuda
@pytest.mark.parametrize("m, k, n", [(6272, 576, 64), (130, 144, 80), (32, 4096, 512), (1, 16, 16)])
def testInt8WmmaVecExactOnCard(m, k, n):
    """The WMMA kernel's 16-byte-load instance, which the route now reaches
    only at an empty product and ``chip_smoke.py`` times as the yardstick,
    equals the plain version exactly: a conv shape, tile edges, split-K at
    M = 32 and a single element tile; every output written (a sentinel
    fill)."""
    device = _cuda()
    from puzzlelib_tpu_torch.ops.hopper import matmul

    a, b = _cardInt8(device, 10, m, k), _cardInt8(device, 11, k, n)
    got = torch.full((m, n), -2 ** 31, device=device, dtype=torch.int32)
    before = (matmul.launchesInt8, matmul.launchesInt8Wgmma)
    matmul._launch(a, b, got, "tiled-vec")
    torch.cuda.synchronize()

    assert (matmul.launchesInt8, matmul.launchesInt8Wgmma) == (before[0] + 1, before[1])
    assert torch.equal(got, matmul.plain(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [False, True])
def testQuantLinearPaddedOnCardMatchesCpu(transpose):
    """An int8 Linear of 27 in-features on the card: its table padded once to
    32, its product one launch on ``wgmma`` with no other launch, and its
    values the CPU's bit for bit."""
    device = _cuda()
    from puzzlelib_tpu_torch.ops import quant
    from puzzlelib_tpu_torch.ops.hopper import matmul

    rng = np.random.RandomState(18)
    x = torch.from_numpy(rng.randn(40, 27).astype(np.float32))
    wq, wscale, xscale = _quantOperands(rng, (24, 27) if transpose else (27, 24), 0 if transpose else 1)
    wt, wscale = quant.linearOperand(torch.from_numpy(wq), transpose), torch.from_numpy(wscale)
    b = torch.from_numpy(rng.randn(24).astype(np.float32))

    want = quant.quantLinear(x, wt, wscale, xscale, b)
    before = (matmul.launches, matmul.launchesInt8, matmul.launchesInt8Wgmma)
    got = quant.quantLinear(x.to(device), wt.to(device), wscale.to(device), xscale, b.to(device))
    after = (matmul.launches, matmul.launchesInt8, matmul.launchesInt8Wgmma)

    assert tuple(y - x for x, y in zip(before, after)) == (0, 1, 1)
    assert torch.equal(got.cpu(), want)
