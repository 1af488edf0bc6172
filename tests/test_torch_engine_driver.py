"""The native host driver (``converter/engine/src``: ``engine_driver.cpp``,
``routes.h``, ``build.py``) and the program it reads
(``converter/engine/program.py``).

The driver is built once for this module with ``buildDriver`` (``g++``
against the installed torch; ~10 s, then cached by its sources' hash).  On
the CPU: the narrow VGG-shaped net's f32, bf16 and int8 engines give
``Engine``'s output bit for bit through the driver; its f32 and int8 outputs
are held against the JAX package's ``Engine`` at the tolerances of
``test_torch_engine.py``'s twins; one-node programs written by hand hold
the driver's C++ registrations of the four custom operators to the Python
plain versions (no CPU graph records ``matmul``, ``winograd_conv2d`` or
``flash``, so this is where their CPU registrations run); ``routes.h``
against ``matmul._route`` and ``flash.blockRows``; the driver's refusals.
The CUDA cases (``cuda`` marker) hold the CUDA registrations to the
Python wrappers' launches on the card, on every path of ``routes.h``.
"""

import ctypes
import json
import os
import subprocess

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import containers as TC
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.convert import attrsFromNumpy, paramsFromNumpy
from puzzlelib_tpu_torch.converter.engine import DataCalibrator, Engine, buildEngine
from puzzlelib_tpu_torch.converter.engine.program import ProgramError, Ref, Writer, encode
from puzzlelib_tpu_torch.converter.engine.src import build as driverBuild
from puzzlelib_tpu_torch.handlers import Calculator
from puzzlelib_tpu_torch.ops.hopper import flash, matmul, winograd

from test_torch_engine import _jax, _narrowVGG, _relL2, _runningStats, _Scales, _smallNet, _table


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card (the card-only
    cases set "cuda" themselves)."""
    monkeypatch.setattr(TConfig, "device", "cpu")


@pytest.fixture(scope="module")
def driver():
    return driverBuild.buildDriver(log=False)


def _run(driver, device, program, out, *inputs, runs=1):
    """(exit code, stderr, the report line's object or None)."""
    cmd = [str(driver)] + (["--runs", str(runs)] if runs != 1 else []) + [device, str(program), str(out)]
    proc = subprocess.run(cmd + [str(x) for x in inputs], capture_output=True, text=True, timeout=300)

    report = None
    for line in proc.stderr.splitlines():
        if line.startswith("engine_driver: report "):
            report = json.loads(line[len("engine_driver: report "):])
    return proc.returncode, proc.stderr, report


def _nodes(program, op):
    with open(program) as f:
        return sum(line.split()[2] == "puzzlelib::" + op for line in f if line.startswith("node "))


def _serveThroughDriver(driver, tmp_path, enginepath, x, device="cpu"):
    np.save(tmp_path / "x.npy", x)
    program = enginepath.replace(".engine", ".program")
    rc, err, report = _run(driver, device, program, tmp_path / "out.npy", tmp_path / "x.npy")
    assert rc == 0, err
    assert "engine_driver: wrote %s" % (tmp_path / "out.npy") in err
    return np.load(tmp_path / "out.npy"), report, program


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def testNarrowEngineThroughDriverIsEngine(driver, tmp_path, dtype):
    """The narrow VGG-shaped net's engine of each type: the driver's output
    ``np.array_equal`` to ``Engine``'s on the same input; in the int8
    program, its five ``puzzlelib::matmul_nt`` nodes run the C++ plain
    version, one call each."""
    np.random.seed(3)
    net = _narrowVGG(T, TC, "he")
    calib = np.random.RandomState(4).randn(16, 3, 16, 16).astype(np.float32)
    x = np.random.RandomState(5).randn(4, 3, 16, 16).astype(np.float32)

    path = buildEngine(net, (4, 3, 16, 16), str(tmp_path), dtype=dtype, returnEngine=False,
                       calibrator=DataCalibrator(calib, batchsize=8) if dtype == "int8" else None)
    want = Engine(path)(torch.from_numpy(x)).numpy()
    got, report, program = _serveThroughDriver(driver, tmp_path, path, x)

    assert got.dtype == np.float32 and got.shape == (4, 10)
    assert np.array_equal(got, want)
    assert report["device"] == "cpu" and report["launches"] == dict.fromkeys(report["launches"], 0)
    assert report["calls"]["matmul_nt"] == _nodes(program, "matmul_nt") == (5 if dtype == "int8" else 0)


def testF32DriverTwin(driver, tmp_path):
    """``testEngineBuildAndRunTwin``'s small net (its BatchNorm2D's running
    stats carried across) through the driver, against the JAX package's
    engine on the same weights: within 1e-5, that test's bound."""
    J, JC, _, JE = _jax()
    from puzzlelib_tpu.backend import gpuarray as jgpu

    np.random.seed(1)
    jnet = _smallNet(J, JC)
    tnet = _smallNet(T, TC, initscheme="none")
    paramsFromNumpy(tnet, _table(jnet))
    attrsFromNumpy(tnet, _runningStats(jnet))

    data = np.random.randn(1, 3, 8, 8).astype(np.float32)
    path = buildEngine(tnet, (1, 3, 8, 8), str(tmp_path), returnEngine=False)
    got, _, _ = _serveThroughDriver(driver, tmp_path, path, data)

    os.makedirs(tmp_path / "jax")
    jpath = JE.buildEngine(jnet, (1, 3, 8, 8), str(tmp_path / "jax"), returnEngine=False)
    want = JE.Engine(jpath)(jgpu.to_gpu(data)).get()
    assert got.shape == want.shape == (1, 10) and np.abs(got - want).max() <= 1e-5


def testInt8DriverTwin(driver, tmp_path):
    """``testNarrowVGGInt8EngineTwin``'s injected case through the driver: the
    JAX calibrator's scales in the port's build, the JAX package's int8
    engine on the same weights, 4 images; relative L2 within 1e-5, that
    test's bound (the int8 products agree exactly)."""
    J, JC, JH, JE = _jax()

    np.random.seed(3)
    jnet = _narrowVGG(J, JC, "he")
    tnet = _narrowVGG(T, TC, "none")
    paramsFromNumpy(tnet, _table(jnet))

    rng = np.random.RandomState(4)
    calib = rng.randn(32, 3, 16, 16).astype(np.float32)
    x = rng.randn(4, 3, 16, 16).astype(np.float32)

    jcal = JE.DataCalibrator(calib, batchsize=16, algo="minmax")
    jnet.evalMode()
    modules = JE.buildengine._quantizableModules(jnet)
    jscales = jcal.calibrate(jnet, modules)

    os.makedirs(tmp_path / "jax")
    jpath = JE.buildEngine(jnet, (4, 3, 16, 16), str(tmp_path / "jax"), dtype="int8", calibrator=jcal,
                           returnEngine=False)
    want = JH.Calculator(JE.Engine(jpath), batchsize=4).calcFromHost(x)

    tpath = buildEngine(tnet, (4, 3, 16, 16), str(tmp_path), dtype="int8", returnEngine=False,
                        calibrator=_Scales([jscales[id(mod)] for mod in modules]))
    got, report, _ = _serveThroughDriver(driver, tmp_path, tpath, x)

    assert got.shape == want.shape == (4, 10) and _relL2(got, want) <= 1e-5
    assert np.array_equal(got, Calculator(Engine(tpath), batchsize=4).calcFromHost(x))


# -- one-node programs: the C++ registrations against the Python operators ----------------------------

def _operands(case, device):
    """(operator, {constant: tensor}, extra arguments, the Python result)
    of one case; the Python result by the wrapper, which runs the plain
    version on the CPU and launches the kernel on the card."""
    gen = np.random.RandomState(sum(map(ord, case)))

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.from_numpy(gen.randn(*shape).astype(np.float32)) * scale).to(dtype).to(device)

    def ints(*shape):
        return torch.from_numpy(gen.randint(-128, 128, shape).astype(np.int8)).to(device)

    kind, _, variant = case.partition("-")
    if kind == "matmul":
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[variant.split("-")[0]]
        m, k, n = {"f32": (5, 24, 9), "bf16": (8, 40, 16), "int8": (6, 48, 10)}[variant]
        a, b = (ints(m, k), ints(k, n)) if dtype == torch.int8 else (randn(m, k, dtype=dtype), randn(k, n, dtype=dtype))
        return "matmul", {"a": a, "b": b}, [], matmul.matmul(a, b)

    if kind == "matmulnt":
        a, bt = ints(7, 32), ints(12, 32)
        return "matmul_nt", {"a": a, "bt": bt}, [], matmul.matmulNT(a, bt)

    if kind == "winograd":
        pad = [1, 1] if variant == "pad1" else [0, 0]
        x, w = randn(2, 8, 7, 6, dtype=torch.bfloat16), randn(16, 8, 3, 3, dtype=torch.bfloat16, scale=0.3)
        return "winograd_conv2d", {"x": x, "w": w}, [pad], winograd.conv2d(x, w, pad)

    causal = variant == "causal"
    q = randn(2, 2, 12, 32, dtype=torch.bfloat16)
    k, v = randn(2, 2, 20, 32, dtype=torch.bfloat16), randn(2, 2, 20, 32, dtype=torch.bfloat16)
    return "flash", {"q": q, "k": k, "v": v}, [causal], flash.flash(q, k, v, causal)


def _oneNode(tmp_path, device, op, constants, extra, index=None):
    """A program of one ``puzzlelib::<op>`` node on ``constants`` (no input),
    its output (or the ``index``-th of its outputs) cast to f32."""
    writer = Writer(device)
    for name, t in constants.items():
        writer.const(name, t)

    writer.node("op", "puzzlelib::" + op, "", [Ref(name) for name in constants] + extra)
    result = "op"
    if index is not None:
        writer.getitem("item", "op", index)
        result = "item"
    writer.node("out", "aten::to", "dtype", [Ref(result), torch.float32])
    writer.output("out")

    program = tmp_path / ("%s.program" % op)
    writer.save(program, tmp_path / ("%s.weights" % op))
    return program


_CASES = ["matmul-f32", "matmul-bf16", "matmul-int8", "matmulnt", "winograd-pad1", "winograd-pad0", "flash-plain",
          "flash-causal"]


def _heldOneNode(driver, tmp_path, device, case):
    op, constants, extra, want = _operands(case, device)
    wants = list(want) if isinstance(want, tuple) else [want]

    for index, expected in enumerate(wants):
        program = _oneNode(tmp_path, device, op, constants, extra, index if len(wants) > 1 else None)
        rc, err, report = _run(driver, device.split(":")[0], program, tmp_path / "out.npy")
        assert rc == 0, err
        assert report["calls"][op] == 1 and report["launches"][op] == (device != "cpu")

        got = torch.from_numpy(np.load(tmp_path / "out.npy"))
        if expected.dtype == torch.int32:
            assert expected.abs().max() < 2 ** 24   # exact in f32
        assert got.shape == expected.shape and torch.equal(got, expected.float().cpu()), (case, index)


@pytest.mark.parametrize("case", _CASES)
def testOneNodeProgramIsPlain(driver, tmp_path, case):
    """Each custom operator's C++ CPU registration, in a program of one node,
    ``torch.equal`` to the Python plain version on the same operands:
    ``matmul`` in f32, bf16 and int8, ``matmul_nt``, ``winograd_conv2d`` at
    pad (1, 1) and (0, 0), ``flash`` causal and not (out and lse)."""
    _heldOneNode(driver, tmp_path, "cpu", case)


# -- routes.h against the Python rules ----------------------------------------------------------

_SHIM = r"""
#include "routes.h"
extern "C" int route(long long m, long long n, long long k, int dtype, int aligned, int sms)
{ return routes::matmulRoute(m, n, k, dtype, aligned != 0, sms); }
extern "C" int blockRows(long long seqQ, long long bh, long long d, int sms)
{ return routes::flashBlockRows(seqQ, bh, d, sms); }
"""


@pytest.fixture(scope="module")
def routesLib(tmp_path_factory):
    where = tmp_path_factory.mktemp("routes")
    (where / "shim.cpp").write_text(_SHIM)
    subprocess.run(["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-I", str(driverBuild.SOURCE_DIR),
                    str(where / "shim.cpp"), "-o", str(where / "shim.so")], check=True, timeout=120)

    lib = ctypes.CDLL(str(where / "shim.so"))
    lib.route.argtypes = [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3
    lib.blockRows.argtypes = [ctypes.c_longlong] * 3 + [ctypes.c_int]
    return lib


def _parametrized(test, argnames):
    """The cases of a parametrized test for ``argnames``, as its mark lists
    them."""
    (mark, ) = [m for m in test.pytestmark if m.name == "parametrize" and m.args[0] == argnames]
    return mark.args[1]


_PATHS = {0: "tiled", 1: "tiled-vec", 2: "wgmma-64", 3: "wgmma-128"}


def testRoutesMatchTheWrappers(routesLib):
    """``routes.h`` picks the path ``matmul._route`` picks on every case of
    ``test_torch_matmul.py``'s route test and on the tile-edge shapes of its
    wgmma test in each type, on both alignments and on cards of 66 and 132
    SMs, and the block height ``flash.blockRows`` picks on every case of
    ``test_torch_flash.py``'s."""
    import test_torch_flash
    import test_torch_matmul

    cases = _parametrized(test_torch_matmul.testRouteChoosesTheKernelFromTheShape, "m, n, k, dtype, aligned, path")
    edges = _parametrized(test_torch_matmul.testWgmmaTileEdges, "m, k, n")
    assert len(cases) >= 15 and len(edges) >= 6
    cases = cases + [(m, n, k, dtype, True, None) for m, k, n in edges for dtype in matmul._DTYPES]
    for m, n, k, dtype, aligned, path in cases:
        for align in (aligned, not aligned):
            for sms in (66, 132):
                want = matmul._route(m, n, k, dtype, align, sms)
                got = _PATHS[routesLib.route(m, n, k, matmul._DTYPES[dtype], align, sms)]
                assert got == want, (m, n, k, dtype, align, sms)
        if path is not None:
            assert _PATHS[routesLib.route(m, n, k, matmul._DTYPES[dtype], aligned, 132)] == path

    for (seqQ, bh, d, sms), rows in test_torch_flash._BLOCK_ROWS:
        assert routesLib.blockRows(seqQ, bh, d, sms) == flash.blockRows(seqQ, bh, d, sms) == rows


@pytest.mark.parametrize("value", [object(), [1, "a"], torch.complex64], ids=["object", "mixed-list", "complex"])
def testProgramRefusesWhatItCannotWrite(value):
    """An argument the program has no token for raises at build time, naming
    the node."""
    with pytest.raises(ProgramError, match=r"node n7 \(aten::x.default\)"):
        encode(value, "node n7 (aten::x.default)")


def testDriverSourcesStandAlone():
    """The driver's sources and its program writer reach nothing of the JAX
    package: no include of ``puzzlelib_tpu/`` and no import of JAX or of the
    JAX package (the ``.npy`` reader and writer are the driver's own copy)."""
    import re

    program = driverBuild.SOURCE_DIR.parent / "program.py"
    for path in [driverBuild.SOURCE_DIR / name for name in driverBuild.SOURCES] + [driverBuild.SOURCE_DIR / "build.py",
                                                                                   program]:
        text = path.read_text()
        assert not re.search(r'#include\s*[<"](?!routes\.h)[^>"]*puzzlelib_tpu/', text), path
        assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|puzzlelib_tpu)\b(?!_torch)", text, re.M), path


# -- refusals ------------------------------------------------------------------------------------

def _narrowEngine(tmp_path):
    np.random.seed(3)
    return buildEngine(_narrowVGG(T, TC, "he"), (2, 3, 16, 16), str(tmp_path), returnEngine=False)


@pytest.mark.parametrize("fault", ["cuda-program", "wrong-device", "unknown-op", "truncated-weights", "bad-line"])
def testDriverRefuses(driver, tmp_path, fault):
    """Each of these ends the run with exit code 1 and a message, and writes
    nothing: a ``cuda`` program (given ``cpu``, and to this CPU-only build
    given ``cuda``); an operator no library registers; a ``.weights`` file
    cut short; a malformed line."""
    program = _narrowEngine(tmp_path).replace(".engine", ".program")
    np.save(tmp_path / "x.npy", np.zeros((2, 3, 16, 16), np.float32))
    text = open(program).read()
    device, message = "cpu", None

    if fault == "cuda-program":
        text = text.replace("device cpu", "device cuda:0")
        message = "was built for cuda:0, not for cpu"
    elif fault == "wrong-device":
        device = "cuda"
        message = "was built for cpu, not for cuda"
    elif fault == "unknown-op":
        text = text.replace("aten::relu default", "aten::relu_nonexistent default", 1)
        message = "no operator aten::relu_nonexistent is registered"
    elif fault == "truncated-weights":
        weights = program.replace(".program", ".weights")
        data = open(weights, "rb").read()
        open(weights, "wb").write(data[:len(data) // 2])
        message = "truncated or another engine's"
    else:
        text = text.replace("\nnode ", "\nnode broken\nnode ", 1)
        message = "malformed 'node' line"

    open(program, "w").write(text)
    rc, err, _ = _run(driver, device, program, tmp_path / "out.npy", tmp_path / "x.npy")

    assert rc == 1 and message in err, err
    assert not (tmp_path / "out.npy").exists()

    if fault == "cuda-program" and torch.version.cuda is None:
        rc, err, _ = _run(driver, "cuda", program, tmp_path / "out.npy", tmp_path / "x.npy")
        assert rc == 1 and "built without CUDA" in err, err


# -- on the card ---------------------------------------------------------------------------------

def _card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the driver's CUDA registrations launch the CUDA C++ kernels")
    monkeypatch.setattr(TConfig, "device", "cuda")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("case", [case for case in _CASES if case.startswith("matmul")])
def testOneNodeProgramOnCard(driver, tmp_path, monkeypatch, case):
    """The products' C++ CUDA registrations, in a program of one node on the
    card, ``torch.equal`` to the Python wrapper's launch of the same kernel
    on the same operands, with one launch counted (f32 on the tiled kernel,
    bf16 and int8 on wgmma).  K2 and K4 take wider operands than the CPU
    cases': ``testOneNodeWinogradOnCard`` and ``testOneNodeFlashOnCard``."""
    _heldOneNode(driver, tmp_path, _card(monkeypatch), case)


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [[1, 1], [0, 0]])
def testOneNodeWinogradOnCard(driver, tmp_path, monkeypatch, pad):
    """``winograd_conv2d`` at (2, 128, 14, 14) x (128, 128, 3, 3) bf16 through
    the driver, ``torch.equal`` to ``winograd.conv2d`` on the card."""
    device = _card(monkeypatch)
    gen = torch.Generator(device=device).manual_seed(7)
    x = torch.randn((2, 128, 14, 14), generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((128, 128, 3, 3), generator=gen, device=device) * 0.05).to(torch.bfloat16)

    program = _oneNode(tmp_path, device, "winograd_conv2d", {"x": x, "w": w}, [pad])
    rc, err, report = _run(driver, "cuda", program, tmp_path / "out.npy")
    assert rc == 0, err
    assert report["launches"]["winograd_conv2d"] == 1
    assert torch.equal(torch.from_numpy(np.load(tmp_path / "out.npy")), winograd.conv2d(x, w, pad).float().cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def testOneNodeFlashOnCard(driver, tmp_path, monkeypatch, causal):
    """``flash`` at (2, 4, 256, 64) bf16 through the driver: out and lse
    ``torch.equal`` to ``flash.flash`` on the card."""
    device = _card(monkeypatch)
    gen = torch.Generator(device=device).manual_seed(8)
    q, k, v = (torch.randn((2, 4, 256, 64), generator=gen, device=device).to(torch.bfloat16) for _ in range(3))
    want = flash.flash(q, k, v, causal)

    for index in (0, 1):
        program = _oneNode(tmp_path, device, "flash", {"q": q, "k": k, "v": v}, [causal], index)
        rc, err, report = _run(driver, "cuda", program, tmp_path / "out.npy")
        assert rc == 0, err
        assert report["launches"]["flash"] == 1
        assert torch.equal(torch.from_numpy(np.load(tmp_path / "out.npy")), want[index].float().cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("m, k, n, dtype, path", [
    (32, 4096, 1024, torch.bfloat16, "wgmma-64"),     # split-K: 8 output tiles
    (4096, 4096, 4096, torch.bfloat16, "wgmma-128"),  # bound by its operations
    (64, 256, 250, torch.bfloat16, "tiled"),          # N off a multiple of 8
    (32, 1024, 512, torch.float32, "tiled-vec"),      # f32 on FFMA, split-K
    (96, 512, 256, torch.int8, "wgmma-128"),          # int8, B laid out as B^T at the call
    (32, 40, 64, torch.int8, "tiled"),                # int8, K off a multiple of 16: WMMA
])
def testMatmulPathsOnCard(driver, tmp_path, monkeypatch, m, k, n, dtype, path):
    """``matmul`` through the driver on every path of ``routes.h``, split-K
    included: ``torch.equal`` to ``matmul.matmul`` on the card."""
    device = _card(monkeypatch)
    gen = torch.Generator(device=device).manual_seed(m + k + n)
    if dtype == torch.int8:
        a = torch.randint(-128, 128, (m, k), generator=gen, device=device, dtype=torch.int8)
        b = torch.randint(-128, 128, (k, n), generator=gen, device=device, dtype=torch.int8)
    else:
        a = torch.randn((m, k), generator=gen, device=device).to(dtype)
        b = (torch.randn((k, n), generator=gen, device=device) / k ** 0.5).to(dtype)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert matmul._route(m, n, k, dtype, True, sms) == path
    splits = matmul._entries()[0](m, n, k, matmul._DTYPES[dtype], matmul._PATHS[path], sms)
    if (m, dtype) in ((32, torch.bfloat16), (32, torch.float32)):
        assert splits > 1

    want = matmul.matmul(a, b)
    program = _oneNode(tmp_path, device, "matmul", {"a": a, "b": b}, [])
    rc, err, report = _run(driver, "cuda", program, tmp_path / "out.npy")
    assert rc == 0, err
    assert report["launches"]["matmul"] == 1
    if want.dtype == torch.int32:
        assert want.abs().max() < 2 ** 24
    assert torch.equal(torch.from_numpy(np.load(tmp_path / "out.npy")), want.float().cpu())
