"""The deployment engine (``converter/engine``: ``buildEngine``, ``Engine``,
``DataCalibrator``), the engine slice's helpers (``tools/engineslice.py``)
and ``checkinstall``, against the JAX package where it has a counterpart.

Twins of ``tests/test_converters.py``'s engine tests (its small net whole,
its BatchNorm2D's running stats carried across), a narrow VGG-shaped net
through both packages' int8 engines and ``Calculator``s, and the engine's
own protocol: ``many``, ``manyRepeat``, a load in a fresh process, the
device check.  The CUDA cases run only where a card is present.
"""

import copy
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import containers as TC
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.convert import attrsFromNumpy, paramsFromNumpy
from puzzlelib_tpu_torch.converter.engine import DataCalibrator, Engine, buildEngine
from puzzlelib_tpu_torch.handlers import Calculator


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a K1-int8 product in the exported graph: int8 operands (the activations and
# the K-major table), an int32 result
_INT8_OP = re.compile(r'"i32\[[0-9, ]*\]" = torch\.ops\.puzzlelib\.matmul_nt\.default\((\w+), (\w+)\)')


def _jax():
    """The JAX package's modules, containers, handlers and engine, for the
    twin tests.  They skip where it does not import, as on the card's
    machine, where only the CUDA cases run."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    from puzzlelib_tpu import containers, handlers, modules
    from puzzlelib_tpu.converter import engine

    return modules, containers, handlers, engine


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card, for every test
    of this file (the card-only ones set "cuda" themselves)."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _cos(a, b):
    return float(np.sum(a * b) / (np.linalg.norm(a) * np.linalg.norm(b)))


def _relL2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _table(net):
    return {name: var.data.get() for var, names in net.getVarTable().items() for name in names}


def _smallNet(M, C, initscheme=None):
    """``tests/test_converters.py`` ``buildSmallNet``."""
    net = C.Sequential(name="convnet")
    net.append(M.Conv2D(3, 4, 3, pad=1, initscheme=initscheme, name="conv1"))
    net.append(M.BatchNorm2D(4, name="bn1"))
    net.append(M.Activation(M.relu, name="relu1"))
    net.append(M.MaxPool2D(name="pool1"))
    net.append(M.Flatten(name="flatten"))
    net.append(M.Linear(4 * 4 * 4, 10, initscheme=initscheme, name="fc"))
    net.append(M.SoftMax(name="probs"))
    return net


def _runningStats(jnet, seed=21):
    """Running stats off (0, 1) for the JAX net's ``bn1``, as a table of the
    port's attribute names: an eval-mode BatchNorm2D that is no identity."""
    rng = np.random.RandomState(seed)
    table = {"bn1.mean": rng.randn(1, 4, 1, 1).astype(np.float32),
             "bn1.var": rng.uniform(0.5, 2.0, (1, 4, 1, 1)).astype(np.float32)}

    jnet["bn1"].mean.set(table["bn1.mean"])
    jnet["bn1"].var.set(table["bn1.var"])
    return table


def _qnet(M, C):
    """``testInt8Engine``'s net."""
    net = C.Sequential(name="qnet")
    net.append(M.Conv2D(1, 8, 3, pad=1))
    net.append(M.MaxPool2D())
    net.append(M.Activation(M.relu))
    net.append(M.Flatten())
    net.append(M.Linear(8 * 6 * 6, 10))
    return net


def _narrowVGG(M, C, initscheme):
    """Two VGG stages at 8 and 16 maps, 3x3 pad-1 convs, then Flatten ->
    Linear: VGG's layout and names, narrow, without the SoftMax."""
    net = C.Sequential(name="narrow")

    inmaps = 3
    for stage, maps in enumerate((8, 16), start=1):
        for i in (1, 2):
            net.append(M.Conv2D(inmaps, maps, 3, pad=1, initscheme=initscheme, name="conv%d_%d" % (stage, i)))
            net.append(M.Activation(M.relu, name="relu%d_%d" % (stage, i)))
            inmaps = maps

        net.append(M.MaxPool2D(2, 2, name="pool%d" % stage))

    net.append(M.Flatten())
    net.append(M.Linear(16 * 4 * 4, 10, initscheme=initscheme, name="fc"))
    return net


def testEngineBuildAndRunTwin(tmp_path):
    """An f32 engine gives the eager net's output (1e-5), loaded back from
    disk as a deployment process loads it, and the JAX package's engine's on
    the same weights (1e-5); it writes its spec and its graph."""
    J, JC, _, JE = _jax()
    from puzzlelib_tpu.backend import gpuarray as jgpu

    np.random.seed(1)
    jnet = _smallNet(J, JC)
    tnet = _smallNet(T, TC, initscheme="none")
    paramsFromNumpy(tnet, _table(jnet))
    attrsFromNumpy(tnet, _runningStats(jnet))

    data = np.random.randn(1, 3, 8, 8).astype(np.float32)
    tnet.evalMode()
    expected = tnet(torch.from_numpy(data)).numpy()
    tnet.reset()

    engine = buildEngine(tnet, (1, 3, 8, 8), str(tmp_path))
    out = engine(torch.from_numpy(data)).numpy()
    assert np.allclose(out, expected, atol=1e-5)

    engine2 = Engine(str(tmp_path / "convnet.float32.engine"))
    assert np.allclose(engine2(torch.from_numpy(data)).numpy(), expected, atol=1e-5)

    os.makedirs(tmp_path / "jax")
    jpath = JE.buildEngine(jnet, (1, 3, 8, 8), str(tmp_path / "jax"), returnEngine=False)
    want = JE.Engine(jpath)(jgpu.to_gpu(data)).get()
    assert np.abs(out - want).max() <= 1e-5

    assert (tmp_path / "convnet.float32.graph.txt").exists()
    spec = (tmp_path / "convnet.float32.spec.json").read_text()
    assert '"outshape": [\n    1,\n    10\n  ]' in spec and '"dtype": "float32"' in spec


def testBf16EngineKeepsTheRunningStats(tmp_path):
    """The bf16 engine of the small net: its ``torch.export`` program holds
    the BatchNorm2D's running stats as they were at the build, in f32 (the
    batch norm keeps its state in f32 in a bf16 net), and serves what the
    eager bf16 net serves on them; the user's net keeps its own stats."""
    J, JC, _, _ = _jax()

    np.random.seed(1)
    jnet = _smallNet(J, JC)
    tnet = _smallNet(T, TC, initscheme="none")
    paramsFromNumpy(tnet, _table(jnet))
    stats = _runningStats(jnet)
    attrsFromNumpy(tnet, stats)

    path = buildEngine(tnet, (2, 3, 8, 8), str(tmp_path), dtype="bfloat16", returnEngine=False)
    program = torch.export.load(path)
    held = list(program.constants.values()) + list(program.state_dict.values())
    for name, ary in stats.items():
        want = torch.from_numpy(ary)
        assert any(t.dtype == torch.float32 and t.shape == want.shape and torch.equal(t, want) for t in held), name

    x = np.random.RandomState(22).randn(2, 3, 8, 8).astype(np.float32)
    eager = copy.deepcopy(tnet)
    eager.calcMode(torch.bfloat16)
    eager.evalMode()
    want = eager(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    assert np.array_equal(Engine(path)(torch.from_numpy(x)).numpy(), want)
    assert torch.equal(tnet["bn1"].mean, torch.from_numpy(stats["bn1.mean"]))


def testInt8EngineTwin(tmp_path):
    """``testInt8Engine``: entropy- and minmax-calibrated int8 engines within
    cosine 0.99 of the f32 net; the graph computes its products in int8
    (K1-int8's operator, i8 x i8 -> i32); the f32 net is restored after the
    build; the engine holds no f32 copy of the weights."""
    np.random.seed(11)
    net = _qnet(T, TC)
    calib = np.random.randn(64, 1, 12, 12).astype(np.float32)

    for algo in ("entropy", "minmax"):
        engine = buildEngine(net, inshape=(4, 1, 12, 12), savepath=str(tmp_path), dtype="int8",
                             name="qnet_" + algo, calibrator=DataCalibrator(calib, batchsize=16, algo=algo))

        x = np.random.randn(4, 1, 12, 12).astype(np.float32)
        qout = engine(torch.from_numpy(x)).numpy()

        net.evalMode()
        fout = net(torch.from_numpy(x)).numpy()
        net.reset()

        cos = _cos(qout, fout)
        assert cos > 0.99, "%s int8 engine diverged (cos=%s)" % (algo, cos)

    graph = (tmp_path / "qnet_minmax.int8.graph.txt").read_text()
    products = _INT8_OP.findall(graph)
    assert len(products) == 2
    for a, b in products:
        assert re.search(r'\b%s: "i8\[' % a, graph) and re.search(r'\b%s: "i8\[' % b, graph)

    with open(tmp_path / "qnet_minmax.int8.engine", "rb") as f:
        constants = torch.export.load(f).constants.values()
    weights = [tuple(var.data.shape) for var in net.getVarTable() if var.data.dim() > 1]
    assert not any(t.dtype == torch.float32 and tuple(t.shape) in weights for t in constants)
    assert sum(t.dtype == torch.int8 for t in constants) == 2

    ones = torch.ones((1, 1, 12, 12))
    before = net(ones).numpy()
    net.reset()
    assert np.allclose(before, net(ones).numpy())
    assert all("updateData" not in mod.__dict__ for mod in net.graph)


def testInt8EngineRequiresCalibrator(tmp_path):
    net = TC.Sequential(name="nocal")
    net.append(T.Linear(4, 2))

    with pytest.raises(ValueError, match="DataCalibrator"):
        buildEngine(net, inshape=(1, 4), savepath=str(tmp_path), dtype="int8")


def testHalfPrecisionEngines(tmp_path):
    """bf16 and f16 engines trace a calcMode-cast clone: f32 out, within
    cosine 0.999 of the f32 engine; the user's f32 net is untouched."""
    np.random.seed(13)
    net = TC.Sequential(name="hp")
    net.append(T.Conv2D(3, 4, 3))
    net.append(T.Activation(T.relu))
    net.append(T.Flatten())
    net.append(T.Linear(4 * 6 * 6, 5))

    x = torch.from_numpy(np.random.randn(2, 3, 8, 8).astype(np.float32))
    f32 = buildEngine(net, inshape=(2, 3, 8, 8), savepath=str(tmp_path), dtype="float32")(x).numpy()

    for dt in ("bfloat16", "float16"):
        out = buildEngine(net, inshape=(2, 3, 8, 8), savepath=str(tmp_path), dtype=dt)(x)
        assert out.dtype == torch.float32 and _cos(out.numpy(), f32) > 0.999, dt
        assert (tmp_path / ("hp.%s.spec.json" % dt)).exists()

    assert net[0].W.dtype == torch.float32, "engine build mutated the source net"


@pytest.mark.parametrize("dtype, other", [("bfloat16", "float16"), ("float16", "bfloat16")])
def testHalfPrecisionEngineTwin(tmp_path, dtype, other):
    """``testHalfPrecisionEngines``' net through both packages' engines of one
    half type, on the same weights and input: within 1e-4 relative L2.  The
    readings on the CPU are 0 for the same type and 4.6e-3 between bf16 and
    f16 (against 4.2e-3 and 5.5e-4 from the f32 engine), so a type mixed up
    fails; so does an input not cast, which the port's bf16 modules refuse."""
    J, JC, _, JE = _jax()
    from puzzlelib_tpu.backend import gpuarray as jgpu

    np.random.seed(13)
    jnet = JC.Sequential(name="hp")
    jnet.append(J.Conv2D(3, 4, 3))
    jnet.append(J.Activation(J.relu))
    jnet.append(J.Flatten())
    jnet.append(J.Linear(4 * 6 * 6, 5))

    tnet = TC.Sequential(name="hp")
    tnet.append(T.Conv2D(3, 4, 3, initscheme="none"))
    tnet.append(T.Activation(T.relu))
    tnet.append(T.Flatten())
    tnet.append(T.Linear(4 * 6 * 6, 5, initscheme="none"))
    paramsFromNumpy(tnet, _table(jnet))

    x = np.random.randn(2, 3, 8, 8).astype(np.float32)
    got = buildEngine(tnet, inshape=(2, 3, 8, 8), savepath=str(tmp_path), dtype=dtype)(torch.from_numpy(x)).numpy()

    want = {}
    for dt in (dtype, other):
        os.makedirs(tmp_path / dt)
        jpath = JE.buildEngine(jnet, (2, 3, 8, 8), str(tmp_path / dt), dtype=dt, returnEngine=False)
        want[dt] = JE.Engine(jpath)(jgpu.to_gpu(x)).get()

    assert got.dtype == np.float32 and got.shape == want[dtype].shape == (2, 5)
    assert _relL2(got, want[dtype]) <= 1e-4
    assert _relL2(got, want[other]) > 1e-4


@pytest.mark.parametrize("dtype, half", [("bfloat16", torch.bfloat16), ("float16", torch.float16)])
def testHalfEngineFromBlueprintClone(tmp_path, monkeypatch, dtype, half):
    """bf16 and f16 engines trace a clone rebuilt from the net's blueprint,
    its variables and running stats carried through ``hdf.MemoryStore``
    (``buildengine.halfClone``, no ``h5py``): their output equals that of
    an engine built on a deep-copied clone; the caller's f32 net is
    unchanged after the build, every variable and running stat equal to
    before and still f32."""
    from puzzlelib_tpu_torch import hdf
    from puzzlelib_tpu_torch.converter.engine import buildengine

    np.random.seed(15)
    net = _smallNet(T, TC, initscheme="he")
    stats = {"bn1.mean": np.random.randn(1, 4, 1, 1).astype(np.float32),
             "bn1.var": np.random.uniform(0.5, 2.0, (1, 4, 1, 1)).astype(np.float32)}
    attrsFromNumpy(net, stats)
    before = {name: var.data.clone() for var, names in net.getVarTable().items() for name in names}

    def noH5py():
        raise AssertionError("the clone went through the HDF5 file layer")

    monkeypatch.setattr(hdf, "_h5py", noH5py)
    path = buildEngine(net, (2, 3, 8, 8), str(tmp_path), dtype=dtype, returnEngine=False)

    copied = copy.deepcopy(net)
    copied.evalMode()
    copied.calcMode(half)
    monkeypatch.setattr(buildengine, "halfClone", lambda net, dtype: copied)
    os.makedirs(tmp_path / "copy")
    copypath = buildEngine(net, (2, 3, 8, 8), str(tmp_path / "copy"), dtype=dtype, returnEngine=False)

    x = torch.from_numpy(np.random.RandomState(16).randn(2, 3, 8, 8).astype(np.float32))
    got = Engine(path)(x)
    assert got.dtype == torch.float32 and torch.equal(got, Engine(copypath)(x))

    after = {name: var.data for var, names in net.getVarTable().items() for name in names}
    assert sorted(after) == sorted(before)
    for name, value in before.items():
        assert after[name].dtype == torch.float32 and torch.equal(after[name], value), name
    for name, value in stats.items():
        module, attr = name.split(".")
        held = getattr(net[module], attr)
        assert held.dtype == torch.float32 and torch.equal(held, torch.from_numpy(value)), name


class _Scales:
    """A calibrator that hands out given scales, in module order."""

    def __init__(self, scales):
        self.scales = scales

    def calibrate(self, net, modules):
        return {id(mod): scale for mod, scale in zip(modules, self.scales)}


@pytest.mark.parametrize("scales, bound", [("injected", 1e-5), ("own", 1e-3)])
def testNarrowVGGInt8EngineTwin(tmp_path, scales, bound):
    """A narrow VGG-shaped net through both packages' int8 engines (minmax
    calibration on 32 images in batches of 16) and ``Calculator``s, 12
    images at batch 4, relative L2.  With the JAX calibrator's scales injected
    into the port's build, the int8 products agree exactly and only f32
    rounding of the first conv's input differs: 1e-5.  With each package's
    own calibration the scales differ by the f32 rounding of the calibration
    convs, which may move a quantized activation by one step: 1e-3."""
    J, JC, JH, JE = _jax()

    np.random.seed(3)
    jnet = _narrowVGG(J, JC, "he")
    tnet = _narrowVGG(T, TC, "none")
    paramsFromNumpy(tnet, _table(jnet))

    rng = np.random.RandomState(4)
    calib = rng.randn(32, 3, 16, 16).astype(np.float32)
    x = rng.randn(12, 3, 16, 16).astype(np.float32)

    jcal = JE.DataCalibrator(calib, batchsize=16, algo="minmax")
    jnet.evalMode()
    jscales = jcal.calibrate(jnet, JE.buildengine._quantizableModules(jnet))
    jscales = [jscales[id(mod)] for mod in JE.buildengine._quantizableModules(jnet)]

    os.makedirs(tmp_path / "jax")
    jpath = JE.buildEngine(jnet, (4, 3, 16, 16), str(tmp_path / "jax"), dtype="int8", calibrator=jcal,
                           returnEngine=False)
    want = JH.Calculator(JE.Engine(jpath), batchsize=4).calcFromHost(x)

    calibrator = _Scales(jscales) if scales == "injected" else DataCalibrator(calib, batchsize=16, algo="minmax")
    tpath = buildEngine(tnet, (4, 3, 16, 16), str(tmp_path), dtype="int8", calibrator=calibrator,
                        returnEngine=False)
    got = Calculator(Engine(tpath), batchsize=4).calcFromHost(x)

    assert got.dtype == np.float32 and got.shape == want.shape == (12, 10)
    assert _relL2(got, want) <= bound


def testEngineManyAndManyRepeat(tmp_path):
    """``many`` and ``manyRepeat`` equal per-batch calls, exactly (the same
    program on the same batches)."""
    np.random.seed(5)
    engine = buildEngine(_qnet(T, TC), inshape=(2, 1, 12, 12), savepath=str(tmp_path), dtype="int8",
                         calibrator=DataCalibrator(np.random.randn(8, 1, 12, 12), batchsize=4, algo="minmax"))

    batches = torch.from_numpy(np.random.RandomState(6).randn(3, 2, 1, 12, 12).astype(np.float32))
    each = torch.stack([engine(batches[i]) for i in range(3)])

    assert torch.equal(engine.many(batches), each)
    assert torch.equal(engine.many(batches, steps=2), each[:2])
    assert torch.equal(engine.manyRepeat(batches[1], 4), each[1].expand(4, -1, -1))
    assert engine.dataShapeFrom((2, 1, 12, 12)) == (2, 10)

    with pytest.raises(T.ModuleError, match="expects input shape"):
        engine(torch.zeros(3, 1, 12, 12))

    with pytest.raises(T.ModuleError, match="inference-only"):
        engine.backward(torch.zeros(2, 10))


def testEngineRefusesInputOnAnotherDevice(tmp_path):
    """An engine runs on the device it was built on: an input elsewhere raises
    a clear error before the program runs."""
    engine = buildEngine(_qnet(T, TC), inshape=(2, 1, 12, 12), savepath=str(tmp_path))
    assert engine.device == torch.device("cpu")

    with pytest.raises(T.ModuleError, match="was built for cpu"):
        engine(torch.zeros((2, 1, 12, 12), device="meta"))


_FRESH = """
import sys
import numpy as np
import torch
from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.converter.engine import Engine

Config.device = "cpu"
engine = Engine(sys.argv[1])
out = engine(torch.from_numpy(np.load(sys.argv[2])))
np.save(sys.argv[3], out.numpy())
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "puzzlelib_tpu"))
print("LEAKED", leaked)
"""


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def testEngineLoadsInFreshProcess(tmp_path, dtype):
    """A process that imports only the engine loads the saved program (its
    custom operators registered by ``Engine``'s imports) and gives the
    building process's output exactly."""
    np.random.seed(7)
    net = _narrowVGG(T, TC, "he")
    calib = np.random.RandomState(8).randn(8, 3, 16, 16).astype(np.float32)
    engine = buildEngine(net, (2, 3, 16, 16), str(tmp_path), dtype=dtype,
                         calibrator=DataCalibrator(calib, batchsize=4) if dtype == "int8" else None)

    x = calib[:2]
    np.save(tmp_path / "x.npy", x)
    proc = subprocess.run([sys.executable, "-c", _FRESH, engine.enginepath, str(tmp_path / "x.npy"),
                           str(tmp_path / "out.npy")], cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=ROOT))

    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "LEAKED []" in proc.stdout
    assert np.array_equal(np.load(tmp_path / "out.npy"), engine(torch.from_numpy(x)).numpy())


def testEngineSliceHelpersOnNarrowNet(tmp_path):
    """``tools/engineslice.py`` builds both engines of the slice and serves
    through ``Calculator``: the int8 engine within cosine 0.99 of the f32
    net, the bf16 engine equal to the eager bf16 net on a clone."""
    import copy

    from puzzlelib_tpu_torch.tools import engineslice as Engines

    np.random.seed(9)
    net = _narrowVGG(T, TC, "he")
    data = Engines.images(8, (3, 16, 16))
    paths = Engines.buildEngines(net, str(tmp_path), Engines.images(16, (3, 16, 16), seed=2), batch=4,
                                 name="narrow")
    assert sorted(paths) == ["bfloat16", "int8"]

    net.evalMode()
    want, _ = Engines.serve(net, data, batch=4)
    got, secs = Engines.serve(Engine(paths["int8"]), data, batch=4)
    assert secs > 0 and got.shape == (8, 10) and _cos(got, want) > 0.99

    clone = copy.deepcopy(net)
    clone.calcMode(torch.bfloat16)
    eager, _ = Engines.serve(clone, data, batch=4)
    assert np.array_equal(Engines.serve(Engine(paths["bfloat16"]), data, batch=4)[0], eager)


def testCheckinstallOnCpu(capsys):
    """``checkinstall.main()`` on the CPU prints each probe's line; K0 runs
    its plain version there, exactly."""
    from puzzlelib_tpu_torch import checkinstall

    result = checkinstall.main()
    printed = capsys.readouterr().out

    for line in ("Device: cpu", "GEMM probe: ok", "Conv probe: ok", "Kernel probe (K0): ok", "Install check passed"):
        assert line in printed

    assert result["probe_abs_err"] == 0.0 and result["gemm_rel_err"] <= checkinstall.GEMM_BOUND


def testBuildEngineRejectsUnknownType(tmp_path):
    with pytest.raises(ValueError, match="float32, float16, bfloat16 or int8"):
        buildEngine(_qnet(T, TC), inshape=(1, 1, 12, 12), savepath=str(tmp_path), dtype="float64")


@pytest.mark.cuda
def testProbeKernelExactOnCard():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA C++ built with nvcc")

    from puzzlelib_tpu_torch.ops.hopper import probe

    x = torch.randn((8, 128), device="cuda")
    before = probe.launches
    got = probe.double(x)
    torch.cuda.synchronize()

    assert probe.launches == before + 1 and torch.equal(got, x * 2)


@pytest.mark.cuda
def testNarrowInt8EngineOnCard(monkeypatch, tmp_path):
    """A narrow int8 engine built, saved and reloaded on the card launches
    K1-int8 once per quantized module per batch, every launch on wgmma, and
    nothing else; its graph records ``puzzlelib::matmul_nt`` once a module;
    with the same scales it gives the CPU engine's output (exact products,
    the same f32 statements)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ built with nvcc")

    from puzzlelib_tpu_torch.converter.engine.buildengine import _quantizableModules
    from puzzlelib_tpu_torch.ops.hopper import matmul, winograd

    np.random.seed(10)
    net = _narrowVGG(T, TC, "he")
    calib = np.random.RandomState(11).randn(16, 3, 16, 16).astype(np.float32)
    x = calib[:12]

    net.evalMode()
    modules = _quantizableModules(net)
    scales = DataCalibrator(calib, batchsize=8, algo="minmax").calibrate(net, modules)
    scales = _Scales([scales[id(mod)] for mod in modules])

    want = Calculator(Engine(buildEngine(net, (4, 3, 16, 16), str(tmp_path), dtype="int8", name="cpu",
                                         calibrator=scales, returnEngine=False)), batchsize=4).calcFromHost(x)

    net.to("cuda")
    monkeypatch.setattr(TConfig, "device", "cuda")
    engine = buildEngine(net, (4, 3, 16, 16), str(tmp_path), dtype="int8", name="cuda", calibrator=scales)
    assert engine.device.type == "cuda"

    assert len(_INT8_OP.findall((tmp_path / "cuda.int8.graph.txt").read_text())) == 5

    before = (matmul.launchesInt8, matmul.launchesInt8Wgmma, matmul.launches, winograd.launches)
    got = Calculator(engine, batchsize=4).calcFromHost(x)
    after = (matmul.launchesInt8, matmul.launchesInt8Wgmma, matmul.launches, winograd.launches)

    assert tuple(y - x for x, y in zip(before, after)) == (15, 15, 0, 0)
    assert _relL2(got, want) <= 1e-6
