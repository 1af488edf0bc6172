"""The port's tooling: ``board``, ``Config.debugAllocator`` and
``unittester``.

- ``board.drawBoard`` writes the JAX package's DOT source for the same
  Sequential, Parallel, Graph and nested net (``view=False``; rendering
  needs graphviz's ``dot``, whose absence is tolerated as in the JAX
  package's ``tests/test_toolkit.py``).  ``graphviz`` is imported inside
  ``drawBoard`` only: the module imports without it.
- ``gpuarray.empty`` under ``Config.debugAllocator`` holds the JAX
  package's poison for each type (NaN, the largest integer, 0 for bool),
  and without it is ``torch.empty``.
- ``unittester`` in a process of its own, in a scratch directory, on one
  fast port test and a test there that fails once and then passes: exit 0
  and the "passed only on retry" report; and on a test that always fails:
  the reruns up to the threshold and a failing exit.  It never runs the
  whole suite from inside the suite."""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import containers as TC
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.backend import gpuarray as TG


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax():
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    from puzzlelib_tpu import board, containers, modules

    return SimpleNamespace(M=modules, C=containers, board=board)


def _port():
    from puzzlelib_tpu_torch import board

    return SimpleNamespace(M=T, C=TC, board=board)


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card."""
    monkeypatch.setattr(TConfig, "device", "cpu")


# -- board ----------------------------------------------------------------------------------------------------

def _sequential(P):
    net = P.C.Sequential(name="seqnet")
    net.append(P.M.Linear(4, 4, name="l1"))
    net.append(P.M.Activation(P.M.relu, name="a1"))
    net.append(P.M.Linear(4, 2, name="l2"))
    return net


def _parallel(P):
    net = P.C.Parallel(name="parnet")
    net.append(P.M.Linear(4, 3, name="p1"))
    net.append(P.M.Linear(5, 2, name="p2"))
    return net


def _graph(P):
    M = P.M
    inp = M.Linear(4, 8, name="inp").node()
    left = M.Activation(M.relu, name="left").node(inp)
    right = M.Linear(8, 8, name="right").node(inp)
    out = M.Add(name="add").node(left, right)
    return P.C.Graph(inputs=inp, outputs=out, name="graphnet")


def _nested(P):
    M, C = P.M, P.C
    net = C.Sequential(name="nested")
    net.append(M.Linear(4, 8, name="fc1"))
    net.append(M.Replicate(2, name="rep"))
    net.append(C.Parallel(name="par").append(_sequentialBranch(P)).append(M.Identity(name="skip")))
    net.append(M.Add(name="sum"))

    g1 = M.Activation(M.tanh, name="gt").node()
    g2 = M.Linear(8, 3, name="gl").node(g1)
    net.append(C.Graph(inputs=g1, outputs=g2, name="head"))
    return net


def _sequentialBranch(P):
    branch = P.C.Sequential(name="branch")
    branch.append(P.M.Linear(8, 8, name="b1"))
    branch.append(P.M.Activation(P.M.relu, name="b2"))
    return branch


@pytest.mark.parametrize("build", [_sequential, _parallel, _graph, _nested],
                         ids=["sequential", "parallel", "graph", "nested"])
def testBoardDotSourceAsJax(build, tmp_path):
    """``drawBoard`` writes the same DOT source in both packages."""
    sources = []
    for P, name in ((_jax(), "jax"), (_port(), "port")):
        path = tmp_path / ("%s.gv" % name)

        try:
            P.board.drawBoard(build(P), str(path), view=False)
        except Exception as e:
            # rendering needs the dot binary; writing the source must work
            import graphviz
            if not isinstance(e, graphviz.backend.execute.ExecutableNotFound):
                raise

        sources.append(path.read_text())

    assert sources[1] == sources[0]
    assert "cluster_0" in sources[0]


def testBoardImportsWithoutGraphviz():
    """The module imports in a process where ``import graphviz`` fails;
    ``drawBoard`` then raises the ``ImportError``."""
    script = ("import sys; sys.modules['graphviz'] = None\n"
              "from puzzlelib_tpu_torch import board, config\n"
              "config.device = 'cpu'\n"
              "from puzzlelib_tpu_torch.containers import Sequential\n"
              "try:\n    board.drawBoard(Sequential(name='n'), 'n.gv', view=False)\n"
              "except ImportError:\n    print('REFUSED')\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=ROOT))

    assert proc.returncode == 0 and proc.stdout.strip() == "REFUSED", proc.stderr[-2000:]


# -- the debug allocator --------------------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int32, np.int8, np.uint8, np.bool_],
                         ids=["float32", "float16", "int32", "int8", "uint8", "bool"])
def testDebugAllocatorPoisonsAsJax(dtype, monkeypatch):
    """Under ``debugAllocator`` ``empty`` holds the JAX package's poison."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    from puzzlelib_tpu import config as JConfig
    from puzzlelib_tpu.backend import gpuarray as JG

    monkeypatch.setattr(JConfig, "debugAllocator", True)
    monkeypatch.setattr(TConfig, "debugAllocator", True)

    want = np.asarray(JG.empty((3, 5), dtype=dtype).get())
    got = TG.empty((3, 5), dtype=dtype).numpy()

    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=np.issubdtype(want.dtype, np.floating))
    assert not np.issubdtype(want.dtype, np.floating) or np.isnan(want).all()


def testDebugAllocatorPoisonsBfloat16(monkeypatch):
    monkeypatch.setattr(TConfig, "debugAllocator", True)
    assert torch.isnan(TG.empty((4, ), dtype=torch.bfloat16)).all()


def testEmptyWithoutDebugAllocatorIsTorchEmpty(monkeypatch):
    """Without the flag ``empty`` allocates through ``torch.empty`` and
    fills nothing."""
    monkeypatch.setattr(TConfig, "debugAllocator", False)

    def refuse(*args, **kwargs):
        raise AssertionError("empty filled its tensor")

    calls = []
    original = torch.empty
    monkeypatch.setattr(torch, "full", refuse)
    monkeypatch.setattr(torch, "empty", lambda *a, **k: calls.append(a) or original(*a, **k))

    out = TG.empty((2, 3), dtype=np.int32)
    assert out.shape == (2, 3) and out.dtype == torch.int32 and calls == [((2, 3), )]


# -- unittester -----------------------------------------------------------------------------------------------

FLAKY = '''
import os


def testFailsOnceThenPasses():
    marker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ran-once")
    if not os.path.exists(marker):
        open(marker, "w").close()
        raise AssertionError("the first run fails")
'''

FAILING = '''
def testAlwaysFails():
    raise AssertionError("always")
'''

FAST = os.path.join(ROOT, "tests", "test_torch_toolkit.py") + "::testEmptyWithoutDebugAllocatorIsTorchEmpty"


@pytest.mark.parametrize("kind", ["flaky", "failing"])
def testUnittesterRetries(kind, tmp_path):
    """``unittester`` on one fast port test and a test of ``tmp_path``: a test
    that passed only on a rerun is reported and the exit is 0; a test that
    always fails is rerun up to the threshold (3 runs) and the exit is 1."""
    (tmp_path / ("test_%s.py" % kind)).write_text(FLAKY if kind == "flaky" else FAILING)

    proc = subprocess.run([sys.executable, "-m", "puzzlelib_tpu_torch.unittester", FAST, "test_%s.py" % kind],
                          cwd=str(tmp_path), capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    out = proc.stdout

    if kind == "flaky":
        assert proc.returncode == 0, out[-3000:] + proc.stderr[-2000:]
        assert "unittester: WARNING - 1 test(s) passed only on retry:" in out, out[-3000:]
        assert "retried: %s::testFailsOnceThenPasses" % (tmp_path / "test_flaky.py") in out, out[-3000:]
        assert out.count("rerunning") == 1
    else:
        assert proc.returncode == 1, out[-3000:] + proc.stderr[-2000:]
        assert "(attempt 2/3)" in out and "(attempt 3/3)" in out and "passed only on retry" not in out

    assert "1 failed, 1 passed" in out, out[-3000:]
