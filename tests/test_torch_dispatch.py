"""The measured per-shape dispatch (``Config.*Algo = "auto"``) against the
JAX package's: the tables' keys, the GEMM decision, the race's rule, the
bwd-data key kept apart from the forward's, the fused step's route key,
``optimizeForShape`` on the CPU, a small net under "auto", and the leaves of
``benchmarks/layerprofile``.

On the CPU no hand kernel runs and nothing is raced, in either package; the
rule is held with the race's timer stubbed (``tools/timing.race``), and the
routes with the card's gate stubbed (``ops.conv._kernelMay``), the kernels'
wrappers then running their plain versions.  The JAX package is imported
inside the twins, so the card-only cases run where it is absent.
"""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import fused
from puzzlelib_tpu_torch.backend import blas as TBlas
from puzzlelib_tpu_torch.ops import attention as tattn
from puzzlelib_tpu_torch.ops import conv as tconv
from puzzlelib_tpu_torch.ops.hopper import flash, matmul, winograd
from puzzlelib_tpu_torch.tools import timing


_TYPES = ("float32", "bfloat16", "float16")


def _jax():
    """The JAX package's dispatch modules; the twins skip where it does not
    import, as on the card's machine."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    import jax.numpy as jnp
    from puzzlelib_tpu import config as JConfig
    from puzzlelib_tpu.backend import blas as JBlas
    from puzzlelib_tpu.ops import attention as jattn
    from puzzlelib_tpu.ops import conv as jconv
    from puzzlelib_tpu.ops.pallas import matmul as jmatmul

    return jnp, JConfig, JBlas, jattn, jconv, jmatmul


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """The port on the CPU, with empty tables and its epoch put back after
    each test (the card-only cases set "cuda" themselves)."""
    monkeypatch.setattr(TConfig, "device", "cpu")
    monkeypatch.setattr(TConfig, "dispatchEpoch", TConfig.dispatchEpoch)
    for owner, name in ((matmul, "_dispatch"), (matmul, "_tunedSecs"), (matmul, "_raceMs"),
                        (tconv, "_algoChoice"), (tconv, "_algoMs"), (tattn, "_attnChoice"), (tattn, "_attnMs")):
        monkeypatch.setattr(owner, name, {})


def _jaxFresh(monkeypatch):
    jnp, JConfig, JBlas, jattn, jconv, jmatmul = _jax()
    for owner, name in ((jmatmul, "_dispatch"), (jmatmul, "_tuned"), (jmatmul, "_tunedSecs"),
                        (jconv, "_algoChoice"), (jattn, "_attnChoice")):
        monkeypatch.setattr(owner, name, {})

    return jnp, JConfig, JBlas, jattn, jconv, jmatmul


def _tables():
    return (matmul._dispatch, tconv._algoChoice, tattn._attnChoice)


# -- the keys --------------------------------------------------------------------------------

@pytest.mark.parametrize("dtname", _TYPES)
def testDispatchKeyAndSignatureMatchReference(dtname):
    """``dispatchKey`` and ``_signature`` are the reference's for the same
    shapes and types."""
    jnp, _, _, jattn, _, jmatmul = _jax()
    ttype, jtype = getattr(torch, dtname), getattr(jnp, dtname)

    for m, n, k in ((32, 4096, 9216), (1024, 1024, 1024), (100, 60, 200)):
        assert matmul.dispatchKey(m, n, k, ttype) == jmatmul.dispatchKey(m, n, k, jtype)

    for causal in (False, True):
        for batch, heads, seq, hdim in ((64, 4, 80, 32), (4, 8, 2048, 64)):
            assert (tattn._signature(batch, heads, seq, hdim, causal, ttype)
                    == jattn._signature(batch, heads, seq, hdim, causal, jtype))


_GRID = [(32, 4096, 9216), (1024, 1024, 1024), (1024, 1000, 2048), (2048, 1024, 1000), (128, 64, 64),
         (4096, 4096, 4096), (1023, 1024, 1024), (1024, 1024, 1152)]


@pytest.mark.parametrize("injected", [False, True])
def testGemmAutoDecisionMatchesReference(monkeypatch, injected):
    """Under "auto" the port sends A @ B to K1 exactly where the reference's
    ``_pallasGemmTiles(A, B)`` is not None, over a grid of shapes and types:
    with empty tables (the static prior) and with the same measured
    entries in both (a win or a loss on either side of the prior)."""
    jnp, JConfig, JBlas, _, _, jmatmul = _jaxFresh(monkeypatch)
    import jax

    monkeypatch.setattr(JConfig, "gemmAlgo", "auto")
    monkeypatch.setattr(TConfig, "gemmAlgo", "auto")

    for i, (m, n, k) in enumerate(_GRID):
        for dtname in _TYPES:
            ttype, jtype = getattr(torch, dtname), getattr(jnp, dtname)
            if injected:
                hand = (i + len(dtname)) % 2 == 0
                jmatmul._dispatch[jmatmul.dispatchKey(m, n, k, jtype)] = (512, 512, 512) if hand else None
                matmul._dispatch[matmul.dispatchKey(m, n, k, ttype)] = "hopper" if hand else "torch"

            A = torch.empty((m, k), dtype=ttype, device="meta")
            B = torch.empty((k, n), dtype=ttype, device="meta")
            jA, jB = jax.ShapeDtypeStruct((m, k), jtype), jax.ShapeDtypeStruct((k, n), jtype)

            assert TBlas.useKernel(A, B) == (JBlas._pallasGemmTiles(jA, jB) is not None), (m, n, k, dtname)


# -- the race and its rule -------------------------------------------------------------------

def _stubRace(monkeypatch, times):
    """The card's gate open and the race's timer replaced: ``times`` gives
    each race's {candidate: ms} in turn."""
    queue = list(times)
    monkeypatch.setattr(timing, "raceable", lambda device: True)
    monkeypatch.setattr(timing, "race", lambda candidates, iters, turns: dict(zip(candidates, queue.pop(0))))
    return queue


_CONV = ((2, 128, 8, 8), (128, 128, 3, 3), (1, 1), (1, 1), (1, 1), 1)


@pytest.mark.parametrize("hand, library, conv, gemm", [
    (0.96, 1.0, "hopper", "hopper"),
    (0.97, 1.0, "torch", "hopper"),
    (0.99, 1.0, "torch", "hopper"),
    (1.0, 1.0, "torch", "torch"),
    (2.5, 1.0, "torch", "torch"),
])
def testRaceRule(monkeypatch, hand, library, conv, gemm):
    """The hand kernel is recorded only below 0.97x the library for a conv
    direction and for attention, and only strictly faster for a GEMM; a tie
    goes to the library.  Each race writes its two times beside its choice
    and bumps the epoch."""
    _stubRace(monkeypatch, [(hand, library)] * 5)
    epoch = TConfig.dispatchEpoch

    measured = tconv.measureAlgoChoice(*_CONV)
    assert sorted(measured) == ["bwdData", "fg", "fwd"]
    assert all(result == (conv, hand, library) for result in measured.values())
    assert sorted(tconv._algoChoice.values()) == [conv] * 3 and sorted(tconv._algoMs.values()) == [(hand, library)] * 3

    attn = "flash" if conv == "hopper" else "xla"
    assert tattn.measureAttnChoice(2, 2, 64, 32, False) == (attn, hand, library)
    assert tattn._attnChoice == {tattn._signature(2, 2, 64, 32, False, torch.bfloat16): attn}

    assert matmul.tuneDispatch(64, 32, 48, torch.bfloat16) == gemm
    assert matmul._dispatch == {matmul.dispatchKey(64, 32, 48, torch.bfloat16): gemm}
    assert matmul._raceMs[matmul.dispatchKey(64, 32, 48, torch.bfloat16)] == (hand, library)
    assert TConfig.dispatchEpoch == epoch + 5

    # a measured GEMM is not raced again
    assert matmul.tuneDispatch(64, 32, 48, torch.bfloat16) == gemm and TConfig.dispatchEpoch == epoch + 5


def testNothingToRace(monkeypatch):
    """Where no kernel takes the call (f32, a 5x5 conv, 64 channels, a head
    dim of 48, int8), the measure functions return None and record
    nothing, also with the card's gate open; ``autotune`` times nothing on
    the CPU."""
    assert matmul.autotune(64, 32, 48, torch.bfloat16) is None   # on the CPU

    queue = _stubRace(monkeypatch, [(1.0, 2.0)] * 8)
    assert tconv.measureAlgoChoice(*_CONV[:-1], _CONV[-1], dtype=torch.float32) is None
    assert tconv.measureAlgoChoice((2, 128, 8, 8), (128, 128, 5, 5), (1, 1), (2, 2), (1, 1), 1) is None
    assert tconv.measureAlgoChoice((2, 64, 8, 8), (64, 64, 3, 3), (1, 1), (1, 1), (1, 1), 1) is None
    assert tattn.measureAttnChoice(2, 2, 64, 48, False) is None
    assert tattn.measureAttnChoice(2, 2, 64, 32, False, torch.float32) is None
    assert matmul.tuneDispatch(64, 32, 48, torch.int8) is None

    assert len(queue) == 8 and not any(_tables()) and not matmul._tunedSecs


def testRaceRefusesCapture(monkeypatch):
    """No race runs while a CUDA graph is being recorded: the gate raises."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="recorded"):
        timing.raceable("cuda")

    assert timing.raceable("cpu") is False


def _spies(monkeypatch):
    """Calls of the three Winograd wrappers by direction (they run their
    plain versions on CPU tensors)."""
    calls = {"fwd": 0, "bwdData": 0, "fg": 0}

    def spy(name, direction):
        original = getattr(winograd, name)

        def wrapped(*args, **kwargs):
            calls[direction] += 1
            return original(*args, **kwargs)

        monkeypatch.setattr(winograd, name, wrapped)

    spy("conv2d", "fwd")
    spy("dataGrad", "bwdData")
    spy("filterGrad", "fg")
    return calls


@pytest.mark.parametrize("algo, races, want", [
    ("auto", None, {"fwd": 0, "bwdData": 0, "fg": 0}),
    ("auto", [(1.5, 1.0), (1.5, 1.0), (0.7, 1.0)], {"fwd": 0, "bwdData": 1, "fg": 0}),
    ("auto", [(0.5, 1.0), (0.5, 1.0), (1.5, 1.0)], {"fwd": 1, "bwdData": 0, "fg": 1}),
    ("hopper", [(1.5, 1.0)] * 3, {"fwd": 1, "bwdData": 1, "fg": 1}),
    ("torch", [(0.5, 1.0)] * 3, {"fwd": 0, "bwdData": 0, "fg": 0}),
])
def testBwdDataKeyedApartFromForward(monkeypatch, algo, races, want):
    """A square 128 -> 128 3x3 pad-1 conv, whose bwd-data signature is its
    own forward's in the reference's keys: here each direction is raced and
    routed on its own (the kept divergence), so a forward that loses and a
    bwd-data that wins send only the bwd-data to K2.  Unmeasured, "auto"
    takes the library; "hopper" and "torch" ignore the table."""
    if races is not None:
        _stubRace(monkeypatch, races)
        tconv.measureAlgoChoice(*_CONV)
        assert tconv._algoChoice[("fwd", ) + _CONV[:2] + ((1, 1), )] != tconv._algoChoice[
            ("bwdData", (2, 128, 8, 8), (128, 128, 3, 3), (1, 1))] or races[0] == races[2]

    monkeypatch.setattr(TConfig, "convAlgo", algo)
    # as on the card: bf16 2-d tensors there, which a hand kernel may take but under "torch"
    monkeypatch.setattr(tconv, "_kernelMay", lambda *tensors: TConfig.checkAlgo(TConfig.convAlgo) != "torch")
    calls = _spies(monkeypatch)

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(_CONV[0], generator=gen).to(torch.bfloat16)
    w = (torch.randn(_CONV[1], generator=gen) * 0.1).to(torch.bfloat16)
    stride, pad, dilation, groups = _CONV[2:]

    x = tconv.kernelLayout(x, w.shape, stride, pad, dilation, groups)
    y = tconv.convNd(x, w, None, stride, pad, dilation, groups)
    dx = tconv.convNdBackwardData(y, w, tuple(x.shape), stride, pad, dilation, groups)
    dw, _ = tconv.convNdBackwardParams(x, y, w, stride, pad, dilation, groups)

    assert calls == want
    assert x.is_contiguous(memory_format=torch.channels_last) == (algo != "torch")

    # the routes agree in value with the library's at the bf16 tier
    ref = torch.nn.functional.conv2d(x.float(), w.float(), padding=1)
    assert (y.float() - ref).abs().max() <= 5e-2 * max(1.0, ref.abs().max().item())
    assert dx.shape == x.shape and dw.shape == w.shape


def testResetDispatchCaches(monkeypatch):
    _stubRace(monkeypatch, [(0.5, 1.0)] * 5)
    tconv.measureAlgoChoice(*_CONV)
    tattn.measureAttnChoice(2, 2, 64, 32, False)
    matmul.tuneDispatch(64, 32, 48, torch.bfloat16)
    assert all(_tables())

    epoch = TConfig.dispatchEpoch
    tconv.resetDispatchCaches()
    assert not any(_tables()) and not tconv._algoMs and not matmul._raceMs and not tattn._attnMs
    assert TConfig.dispatchEpoch == epoch + 1


def testUnmeasuredAttentionPrior():
    """"auto" reads the table before the structural prior."""
    args = (4, 8, 2048, 64, False, torch.bfloat16, "cuda")
    assert tattn.resolveAlgo("auto", *args) == "flash"

    TConfig.recordChoice(tattn._attnChoice, tattn._signature(*args[:-1]), "xla")
    assert tattn.resolveAlgo("auto", *args) == "xla"
    assert tattn.resolveAlgo("flash", *args) == "flash"
    assert tattn.resolveAlgo("auto", *args[:-1], "cpu") == "xla"


# -- the fused step ----------------------------------------------------------------------------

def testRouteKeyChangesAfterTableWrite():
    """A table write changes the fused step's route key and drops the
    recordings made before it, which are then recorded again."""
    before = fused._routeKey()
    TConfig.recordChoice(tconv._algoChoice, ("fwd", (1, 128, 4, 4), (128, 128, 3, 3), (1, 1)), "hopper")
    assert fused._routeKey() != before

    recordings, made = fused._Recordings(), []
    record = lambda: made.append(1) or len(made)
    assert recordings.get("step", (1, ), record) == 1
    assert recordings.get("step", (1, ), record) == 1 and recordings.captures == 1

    TConfig.recordChoice(matmul._dispatch, matmul.dispatchKey(8, 8, 8, torch.float32), "torch")
    assert recordings.get("step", (1, ), record) == 2 and recordings.captures == 2


# -- optimizeForShape ---------------------------------------------------------------------------

def _layers(M, kind):
    np.random.seed(0)
    if kind == "linear":
        return M.Linear(64, 32), (8, 64)
    if kind == "conv":
        return M.Conv2D(128, 128, 3, pad=1), (2, 128, 6, 6)
    return M.MultiHeadAttention(64, 2), (2, 16, 64)


@pytest.mark.parametrize("kind", ["linear", "conv", "attention"])
def testOptimizeForShapeOnCpuRecordsNothing(monkeypatch, kind):
    """A Linear, a bf16 conv and an attention layer: ``optimizeForShape``
    on the CPU records nothing in either package."""
    jnp, JConfig, _, jattn, jconv, jmatmul = _jaxFresh(monkeypatch)
    from puzzlelib_tpu import modules as J
    from puzzlelib_tpu_torch import modules as T

    epoch = TConfig.dispatchEpoch
    for M, dtype in ((T, torch.bfloat16), (J, jnp.bfloat16)):
        mod, shape = _layers(M, kind)
        mod.calcMode(dtype)
        mod.optimizeForShape(shape)

    assert not any(_tables()) and TConfig.dispatchEpoch == epoch
    assert not jmatmul._dispatch and not jconv._algoChoice and not jattn._attnChoice


def _narrowNet(M, C):
    """Two 3x3 convs, the maps as a sequence through an attention block,
    and a Linear head: (2, 4, 4, 4) -> (2, 5)."""
    net = C.Sequential()
    net.append(M.Conv2D(4, 8, 3, pad=1, initscheme="he"))
    net.append(M.Activation(M.relu))
    net.append(M.Conv2D(8, 8, 3, pad=1, initscheme="he"))
    net.append(M.Reshape((2, 8, 16)))
    net.append(M.SwapAxes(1, 2))
    net.append(M.MultiHeadAttention(8, 2))
    net.append(M.Reshape((2, 128)))
    net.append(M.Linear(128, 5, initscheme="he"))
    return net


def testAutoNetTwin(monkeypatch):
    """The narrow net in bf16 under "auto" in both packages, after
    ``optimizeForShape``: the same outputs, input gradient and parameter
    gradients at the bf16 tier (5e-2 of max(1, max |want|))."""
    jnp, JConfig, _, _, _, _ = _jaxFresh(monkeypatch)
    import ml_dtypes
    from puzzlelib_tpu import containers as JC, modules as J
    from puzzlelib_tpu.backend import gpuarray as jgpu
    from puzzlelib_tpu_torch import containers as TC, modules as T
    from puzzlelib_tpu_torch.convert import paramsFromNumpy

    for owner in (JConfig, TConfig):
        monkeypatch.setattr(owner, "convAlgo", "auto")
        monkeypatch.setattr(owner, "gemmAlgo", "auto")
        monkeypatch.setattr(owner, "attentionAlgo", "auto")

    np.random.seed(0)
    jnet = _narrowNet(J, JC)
    tnet = _narrowNet(T, TC)
    paramsFromNumpy(tnet, {n: var.data.get() for var, names in jnet.getVarTable().items() for n in names})
    jnet.calcMode(jnp.bfloat16)
    tnet.calcMode(torch.bfloat16)

    jnet.optimizeForShape((2, 4, 4, 4))
    tnet.optimizeForShape((2, 4, 4, 4))

    rng = np.random.RandomState(1)
    x = rng.randn(2, 4, 4, 4).astype(ml_dtypes.bfloat16)
    g = rng.randn(2, 5).astype(ml_dtypes.bfloat16)

    jout = jnet(jgpu.to_gpu(x)).get()
    tout = tnet(torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16))
    jnet.backward(jgpu.to_gpu(g))
    tnet.backward(torch.from_numpy(g.astype(np.float32)).to(torch.bfloat16))

    def close(got, want):
        got, want = got.detach().float().numpy(), np.asarray(want, dtype=np.float32)
        assert got.shape == want.shape and np.isfinite(want).all()
        assert np.abs(got - want).max() <= 5e-2 * max(1.0, np.abs(want).max())

    close(tout, jout)
    close(tnet.grad, jnet.grad.get())

    tgrads = {name: var.grad for var, names in tnet.getVarTable().items() for name in names}
    jgrads = {name: var.grad.get() for var, names in jnet.getVarTable().items() for name in names}
    assert sorted(tgrads) == sorted(jgrads) and len(tgrads) == 14
    for name, want in jgrads.items():
        close(tgrads[name], want)


def testLayerprofileLeavesMatchReference(monkeypatch):
    """``layerprofile._leafModules`` walks the same leaves by the same paths
    as the reference's, containers nested; ``profileNet`` then prints one
    row a leaf with host times on the CPU, routes "library"."""
    _jax()
    from puzzlelib_tpu import containers as JC, modules as J
    from puzzlelib_tpu.benchmarks import layerprofile as jprofile
    from puzzlelib_tpu_torch import containers as TC, modules as T
    from puzzlelib_tpu_torch.benchmarks import layerprofile

    def nested(M, C):
        net = _narrowNet(M, C)
        inner = C.Sequential(name="head")
        inner.append(M.Activation(M.relu))
        inner.append(M.Linear(5, 3))
        net.append(inner)
        return net

    np.random.seed(0)
    want = [path for path, _ in jprofile._leafModules(nested(J, JC))]
    tnet = nested(T, TC)
    got = [path for path, _ in layerprofile._leafModules(tnet)]
    assert got == want and len(got) == 10

    lines = []
    rows = layerprofile.profileNet(tnet, torch.randn(2, 4, 4, 4), stepSecs=0.01, iters=1, out=lines.append)
    assert [row[0] for row in rows] == got
    assert all(not isinstance(row[4], Exception) and row[4][1] == "library" for row in rows)
    assert len(lines) == 1 + len(got) + 2 and lines[-2].startswith("TOTAL")


# -- on the card ---------------------------------------------------------------------------------

def _card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ built with nvcc")

    monkeypatch.setattr(TConfig, "device", "cuda")
    return torch.device("cuda")


@pytest.mark.cuda
def testRaceRecordsLibraryWhereHandLosesFar(monkeypatch):
    """At MiniYolo's conv23, (16, 1024, 7, 7) -> 1024, K2 took 16.6x
    cuDNN's time: the race records the library for the forward, and each
    direction's choice follows its own times under the rule."""
    _card(monkeypatch)
    measured = tconv.measureAlgoChoice((16, 1024, 7, 7), (1024, 1024, 3, 3), (1, 1), (1, 1), (1, 1), 1)

    choice, handMs, libMs = measured["fwd"]
    assert handMs > 2 * libMs and choice == "torch"
    for choice, handMs, libMs in measured.values():
        assert choice == ("hopper" if handMs < tconv.MARGIN * libMs else "torch")


@pytest.mark.cuda
def testAutoLaunchesWhereChosen(monkeypatch):
    """Under "auto" the counters show each kernel launched exactly where the
    table chose it: a conv whose bwd-data alone is "hopper", a product
    recorded "hopper" and one recorded "torch", an attention signature
    recorded "flash"."""
    from puzzlelib_tpu_torch import modules as T

    device = _card(monkeypatch)
    monkeypatch.setattr(TConfig, "convAlgo", "auto")
    monkeypatch.setattr(TConfig, "gemmAlgo", "auto")

    shape, wshape = (2, 128, 8, 8), (128, 128, 3, 3)
    TConfig.recordChoice(tconv._algoChoice, ("fwd", shape, wshape, (1, 1)), "torch")
    TConfig.recordChoice(tconv._algoChoice, ("fg", shape, shape, (1, 1)), "torch")
    TConfig.recordChoice(tconv._algoChoice, ("bwdData", shape, wshape, (1, 1)), "hopper")
    TConfig.recordChoice(matmul._dispatch, matmul.dispatchKey(64, 128, 128, torch.bfloat16), "hopper")
    TConfig.recordChoice(matmul._dispatch, matmul.dispatchKey(64, 256, 128, torch.bfloat16), "torch")

    conv = T.Conv2D(128, 128, 3, pad=1)
    conv.calcMode(torch.bfloat16)
    x = torch.randn(shape, device=device).to(torch.bfloat16)

    before = (winograd.launches, winograd.dataGradLaunches, winograd.filterGradLaunches, matmul.launches)
    y = conv(x)
    conv.backward(torch.randn_like(y))

    a = torch.randn((64, 128), device=device).to(torch.bfloat16)
    TBlas.mulMatrixOnMatrix(a, torch.randn((128, 128), device=device).to(torch.bfloat16))
    TBlas.mulMatrixOnMatrix(a, torch.randn((128, 256), device=device).to(torch.bfloat16))

    after = (winograd.launches, winograd.dataGradLaunches, winograd.filterGradLaunches, matmul.launches)
    assert tuple(n - m for n, m in zip(after, before)) == (1, 1, 0, 1)

    TConfig.recordChoice(tattn._attnChoice, tattn._signature(2, 2, 128, 64, False, torch.bfloat16), "flash")
    attn = T.MultiHeadAttention(128, 2)
    attn.calcMode(torch.bfloat16)
    launches = flash.launches
    attn(torch.randn((2, 128, 128), device=device).to(torch.bfloat16))
    assert flash.launches == launches + 1


@pytest.mark.cuda
def testOptimizeForShapeRacesThroughContainers(monkeypatch):
    """``Sequential.optimizeForShape`` reaches each conv, Linear and
    attention layer at its own shape and records a choice for each."""
    from puzzlelib_tpu_torch import containers as TC, modules as T

    _card(monkeypatch)
    net = TC.Sequential()
    net.append(T.Conv2D(128, 128, 3, pad=1))
    net.append(T.Reshape((2, 128, 64)))
    net.append(T.SwapAxes(1, 2))
    net.append(T.MultiHeadAttention(128, 2))
    net.append(T.Reshape((2, 64 * 128)))
    net.append(T.Linear(64 * 128, 256))
    net.calcMode(torch.bfloat16)

    net.optimizeForShape((2, 128, 8, 8))
    assert len(tconv._algoChoice) == 3 and len(tattn._attnChoice) == 1 and len(matmul._dispatch) == 1

    # K1 alone at the path its route picks, its seconds beside the table's
    assert matmul.autotune(64, 128, 128, torch.bfloat16) == "wgmma-64"
    assert matmul._tunedSecs[matmul.dispatchKey(64, 128, 128, torch.bfloat16)] > 0
