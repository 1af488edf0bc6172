"""The port's measurement path on the CPU: the benchmark CLIs
(``benchmarks/{gemmspeed,convspeed,attnspeed}``) and the probe scripts
(``tools/{roofline,strided_dma,tapdot}_probe``) run as a user runs them, in
a process of their own, with ``--device cpu`` or ``--check`` at small sizes,
and their refusal without a card; ``convNdbenchmark`` and ``timeKernel``;
the profiler (the twin of ``tests/test_tensor.py``'s allocation-trace test).
Card-only cases run the CLIs at small sizes on the card."""

import gc
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card (the CLIs set
    ``Config.device`` themselves; the fixture puts it back)."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _needsCard():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ built with nvcc")


# (module, small arguments on the CPU, text the result shows)
CPU_RUNS = [
    ("benchmarks.gemmspeed", ["--sizes", "256", "--dtypes", "float32,bfloat16,float16,int8", "--iters", "2", "--device",
                              "cpu"], ["256  float32 |", "256     int8 |", "TF/s (cpu)", "TOP/s (cpu)"]),
    ("benchmarks.convspeed", ["--data", "2,32,8,8", "--weights", "64,32,3,3", "--pad", "1", "--dtype", "bfloat16",
                              "--device", "cpu"],
     ["Benchmarking conv data (2, 32, 8, 8) W (64, 32, 3, 3)", "fwd ", "bwdFilter ", "bwdData "]),
    ("benchmarks.convspeed", ["--data", "2,32,8,8", "--weights", "64,32,3,3", "--pad", "1", "--chain", "--device",
                              "cpu"], ["fwd        chain", "bwdData    chain", "bwdFilter  chain", "[library]"]),
    ("benchmarks.attnspeed", ["--seqs", "64", "--batch", "1", "--heads", "2", "--dim", "32", "--iters", "1", "--device",
                              "cpu"], ["seq    64 causal=0", "seq    64 causal=1", "scaled_dot_product_attention", "(cpu)"]),
    ("tools.roofline_probe", ["--check"], ["equal to torch.add(x, 1)"]),
    ("tools.strided_dma_probe", ["--check"], ["exact"]),
    ("tools.tapdot_probe", ["--check"], ["(2, 128, 12, 10, 128) k3: err", "(1, 128, 9, 9, 128) k5: err"]),
]

SCRIPTS = ["benchmarks.gemmspeed", "benchmarks.convspeed", "benchmarks.attnspeed", "tools.roofline_probe",
           "tools.strided_dma_probe", "tools.tapdot_probe"]


def _run(module, argv):
    """``python -m puzzlelib_tpu_torch.<module> argv`` as a user runs it."""
    return subprocess.run([sys.executable, "-m", "puzzlelib_tpu_torch." + module] + argv, cwd=ROOT,
                          capture_output=True, text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))


@pytest.mark.parametrize("module, argv, texts", CPU_RUNS,
                         ids=["gemmspeed", "convspeed", "convspeed-chain", "attnspeed", "roofline", "strided",
                              "tapdot"])
def testCliOnCpu(module, argv, texts):
    """Each script at small sizes on the CPU exits 0 and prints its lines;
    no line names the card or a share of its peak."""
    proc = _run(module, argv)

    assert proc.returncode == 0, proc.stderr[-2000:]
    for text in texts:
        assert text in proc.stdout, proc.stdout
    assert "H100" not in proc.stdout and "peak)" not in proc.stdout


@pytest.mark.parametrize("module", SCRIPTS)
def testCliRefusesWithoutCard(module):
    """Without ``--device cpu`` (or ``--check``), on a machine with no card,
    each script exits non-zero with ``DeviceError`` and prints no result;
    none runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")

    proc = _run(module, [])

    assert proc.returncode != 0 and "DeviceError: no CUDA device" in proc.stderr, proc.stderr[-2000:]
    assert proc.stdout == ""


def testConvNdbenchmarkAndTimeKernel():
    """``convNdbenchmark`` returns one ``ConvPerf`` per direction with a
    positive time (the library route on the CPU), for a conv and for a
    deconvolution (``transpose``); ``timeKernel`` returns
    positive seconds, the mean of one call with ``normalize``."""
    from puzzlelib_tpu_torch.backend import dnn
    from puzzlelib_tpu_torch.backend.device import timeKernel

    results = dnn.convNdbenchmark((2, 8, 10, 10), (16, 8, 3, 3), (1, 1), (1, 1), (1, 1), 1)
    assert len(results) == 3
    for perfs in results:
        assert len(perfs) == 1 and perfs[0].time > 0 and perfs[0].algo == dnn.ConvFwdAlgo.auto
        assert "time" in perfs[0].toString()

    calls = []
    total = timeKernel(lambda: calls.append(1), looplength=5, log=False)
    mean = timeKernel(lambda: calls.append(1), looplength=5, log=False, normalize=True, hotpass=False)
    assert total > 0 and mean > 0 and len(calls) == 11

    # a deconvolution's three directions: (2, 16, 10, 10) is its output,
    # (8, 16, 3, 3) its (inmaps, outmaps, 3, 3) weights
    results = dnn.convNdbenchmark((2, 16, 10, 10), (8, 16, 3, 3), (1, 1), (1, 1), (1, 1), 1, transpose=True)
    assert len(results) == 3
    for perfs in results:
        assert len(perfs) == 1 and perfs[0].time > 0 and perfs[0].algo == dnn.ConvFwdAlgo.auto


def _traceScenario(profiler, gpuarray):
    """``tests/test_tensor.py``'s allocation-trace scenario on one package:
    (live count after three allocations, after one died, the report's
    largest entry, the text report, the final report, the count after an
    allocation once stopped)."""
    profiler.startTraceMalloc()
    try:
        a = gpuarray.empty((4, 4))
        b = gpuarray.zeros((8, ))
        c = gpuarray.to_gpu(np.ones((2, 2), np.float32))
        three = profiler.traceLeaks()

        del b
        gc.collect()
        two = profiler.traceLeaks()

        largest = profiler.liveAllocations()[0]
        text = profiler.formatAllocReport()
    finally:
        final = profiler.stopTraceMalloc()

    d = gpuarray.empty((4, ))
    after = profiler.traceLeaks()
    del a, c, d
    return three, two, largest, text, final, after


def testTraceMallocTwin():
    """The allocation tracer against the JAX package's on the same scenario:
    the same live counts, the same (bytes, shape) entries, the caller named,
    nothing recorded once stopped."""
    from puzzlelib_tpu_torch import profiler
    from puzzlelib_tpu_torch.backend import gpuarray

    three, two, largest, text, final, after = _traceScenario(profiler, gpuarray)

    assert (three, two, after) == (3, 2, 2)
    assert largest[0] == 64 and largest[1] == (4, 4) and "test_torch_benchmarks" in largest[3]
    assert "64" in text and "live in 2 allocations" in text
    assert len(final) == 2

    pytest.importorskip("puzzlelib_tpu.profiler", reason="the twin needs the JAX package")
    from puzzlelib_tpu import profiler as jprofiler
    from puzzlelib_tpu.backend import gpuarray as jgpuarray

    jthree, jtwo, jlargest, _, jfinal, jafter = _traceScenario(jprofiler, jgpuarray)
    assert (jthree, jtwo, jafter) == (three, two, after)
    assert [entry[:2] for entry in jfinal] == [entry[:2] for entry in final]
    assert jlargest[:2] == largest[:2]


def testTraceWritesChromeTrace(tmp_path):
    """``trace`` records the region and writes a Chrome trace that holds the
    ``annotate`` label; ``deviceMemoryStats`` is empty without a card."""
    from puzzlelib_tpu_torch import profiler

    with profiler.trace(str(tmp_path)) as prof:
        with profiler.annotate("puzzle-region"):
            torch.matmul(torch.ones(16, 16), torch.ones(16, 16))

    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]

    assert any(event.get("name") == "puzzle-region" for event in events)
    assert any(item.key == "puzzle-region" for item in prof.key_averages())

    if not torch.cuda.is_available():
        assert profiler.deviceMemoryStats() == {}


@pytest.mark.cuda
@pytest.mark.parametrize("module, argv, texts", [
    ("benchmarks.gemmspeed", ["--sizes", "512", "--dtypes", "bfloat16,int8", "--iters", "2"], ["% peak)"]),
    ("benchmarks.convspeed", ["--data", "2,128,16,16", "--weights", "128,128,3,3", "--pad", "1", "--dtype",
                              "bfloat16"], ["[winograd]"]),
    ("benchmarks.convspeed", ["--data", "2,128,16,16", "--weights", "128,128,3,3", "--pad", "1", "--chain"],
     ["[winograd]"]),
    ("benchmarks.attnspeed", ["--seqs", "256", "--batch", "1", "--heads", "2", "--iters", "2"], ["causal=1"]),
    ("tools.strided_dma_probe", ["--iters", "2"], ["exact; kernel"]),
], ids=["gemmspeed", "convspeed", "convspeed-chain", "attnspeed", "strided"])
def testCliOnCard(module, argv, texts):
    """Each script at small sizes on the card exits 0: the card's name
    first, then its lines."""
    _needsCard()
    proc = _run(module, argv)

    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.splitlines()[0].startswith(torch.cuda.get_device_name(0))
    for text in texts:
        assert text in proc.stdout, proc.stdout


@pytest.mark.cuda
def testProfilerOnCard(tmp_path):
    """On the card the trace holds device kernels, and the memory statistics
    name each card."""
    _needsCard()
    from puzzlelib_tpu_torch import profiler

    x = torch.ones((256, 256), device="cuda")
    with profiler.trace(str(tmp_path)) as prof:
        torch.matmul(x, x)
        torch.cuda.synchronize()

    assert any(item.device_time_total > 0 for item in prof.key_averages())
    stats = profiler.deviceMemoryStats()
    assert sorted(stats) == ["cuda:%d" % i for i in range(torch.cuda.device_count())]
    assert stats["cuda:0"]["allocated_bytes.all.current"] > 0
