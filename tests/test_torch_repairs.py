"""Three faults of the port against the reference, repaired, and their twins:

- a net whose attention runs the flash kernel exports as an engine: K4 is the
  custom operator ``puzzlelib::flash`` (``ops/hopper/flash.flashOp``);
- ``Container.modules`` is the reference's name -> child mapping, and still
  ``nn.Module.modules()`` when called;
- a bf16 training run repeats bit for bit on the card; the embedding
  gradient's ``index_add_``, suspected of varying from run to run, sums
  repeated tokens as an f64 sum rounded once would, and repeats.
"""

import numpy as np
import pytest
import torch
from torch import nn

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import containers as TC
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.convert import paramsFromNumpy
from puzzlelib_tpu_torch.converter.engine import Engine, buildEngine
from puzzlelib_tpu_torch.handlers import Calculator
from puzzlelib_tpu_torch.models.nets import buildTransformerClassifier


def _jax():
    """The JAX package's modules, containers, engine and nets, for the twins;
    they skip where it does not import, as on the card's machine."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    from puzzlelib_tpu import containers, modules
    from puzzlelib_tpu.converter import engine
    from puzzlelib_tpu.models.nets import transformer

    return modules, containers, engine, transformer


def _needsCard():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ built with nvcc")


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card (the card-only
    cases set "cuda" themselves)."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _relL2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _table(net):
    return {name: var.data.get() for var, names in net.getVarTable().items() for name in names}


def _attentionNet(M, C, emb, heads, initscheme=None, **kwargs):
    """A float-input attention net: (batch, seq, emb) -> (batch, seq, emb)."""
    net = C.Sequential(name="attn-net")
    net.append(M.LayerNorm(emb, name="norm"))
    net.append(M.MultiHeadAttention(emb, heads, initscheme=initscheme, name="attn", **kwargs))
    return net


def _narrowVGG(M, C, initscheme):
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


# -- the flash engine ----------------------------------------------------------------

def testFlashEngineTwin(tmp_path):
    """The attention net (emb 64, 2 heads) as a bf16 engine of both packages
    on one weight table: within 1e-2 relative L2.  The port's flash plain
    version rounds P to bf16 before P V, where the JAX package's CPU route is
    the composed attention, so the two differ by about a bf16 rounding.  The
    port's graph records K4 as ``puzzlelib::flash``, and a reload gives the
    same output."""
    J, JC, JE, _ = _jax()
    from puzzlelib_tpu.backend import gpuarray as jgpu

    np.random.seed(21)
    jnet = _attentionNet(J, JC, 64, 2)
    tnet = _attentionNet(T, TC, 64, 2, initscheme="none", attnAlgo="flash")
    paramsFromNumpy(tnet, _table(jnet))

    x = np.random.RandomState(22).randn(2, 16, 64).astype(np.float32)

    engine = buildEngine(tnet, (2, 16, 64), str(tmp_path), dtype="bfloat16")
    got = engine(torch.from_numpy(x)).numpy()

    (tmp_path / "jax").mkdir()
    jpath = JE.buildEngine(jnet, (2, 16, 64), str(tmp_path / "jax"), dtype="bfloat16", returnEngine=False)
    want = JE.Engine(jpath)(jgpu.to_gpu(x)).get()

    assert got.dtype == np.float32 and got.shape == want.shape == (2, 16, 64)
    assert _relL2(got, want) <= 1e-2

    graph = (tmp_path / "attn-net.bfloat16.graph.txt").read_text()
    assert graph.count("torch.ops.puzzlelib.flash.default") == 1
    assert np.array_equal(Engine(engine.enginepath)(torch.from_numpy(x)).numpy(), got)


def testFlashOperatorShape():
    """``puzzlelib::flash``'s shape function: out like q, lse (batch * heads,
    1, seqQ) in f32; it checks the operands as the kernel's wrapper does."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from puzzlelib_tpu_torch.ops.hopper import flash

    with FakeTensorMode():
        q = torch.empty((2, 3, 10, 32), dtype=torch.bfloat16)
        k = torch.empty((2, 3, 7, 32), dtype=torch.bfloat16)
        out, lse = flash.flash(q, k, k, True)

        assert tuple(out.shape) == (2, 3, 10, 32) and out.dtype == torch.bfloat16
        assert tuple(lse.shape) == (6, 1, 10) and lse.dtype == torch.float32

        with pytest.raises(ValueError, match="flash takes q"):
            flash.flash(q, torch.empty((2, 3, 7, 16), dtype=torch.bfloat16), k, False)


@pytest.mark.cuda
def testFlashEngineOnCard(monkeypatch, tmp_path):
    """Built on the card at seq 1024, where "auto" picks flash in bf16: the
    engine launches K4 once a batch and gives the eager bf16 net's output."""
    import copy

    _needsCard()
    from puzzlelib_tpu_torch.ops.hopper import flash

    monkeypatch.setattr(TConfig, "device", "cuda")
    monkeypatch.setattr(TConfig, "globalEvalMode", True)

    np.random.seed(23)
    net = _attentionNet(T, TC, 128, 2)
    assert net["attn"].attnAlgo == "auto"
    x = np.random.RandomState(24).randn(4, 1024, 128).astype(np.float32)

    engine = buildEngine(net, (2, 1024, 128), str(tmp_path), dtype="bfloat16")
    clone = copy.deepcopy(net)
    clone.calcMode(torch.bfloat16)

    before = flash.launches
    got = Calculator(engine, batchsize=2).calcFromHost(x)
    assert flash.launches == before + 2

    want = Calculator(clone, batchsize=2).calcFromHost(x)
    assert np.isfinite(got).all() and _relL2(got, want) <= 1e-3


# -- Container.modules ---------------------------------------------------------------

def testContainerModulesTwin():
    """Iteration, indexing, ``len``, ``in``, ``keys``, ``values`` and
    ``items`` of ``net.modules`` as in the JAX package, for the narrow VGG (a
    Sequential) and the narrow transformer (a Graph)."""
    J, JC, _, JT = _jax()

    pairs = [(_narrowVGG(J, JC, "he"), _narrowVGG(T, TC, "he")),
             (JT.buildTransformerClassifier(50, 16, 32, nheads=2, nlayers=1, nclasses=3),
              buildTransformerClassifier(50, 16, 32, nheads=2, nlayers=1, nclasses=3))]

    for jnet, tnet in pairs:
        names = [name for name in jnet.modules]
        assert [name for name in tnet.modules] == names and len(tnet.modules) == len(jnet.modules)
        assert list(tnet.modules.keys()) == list(jnet.modules.keys())

        for name in names:
            assert name in tnet.modules
            assert tnet.modules[name] is tnet[name]
            assert tnet.modules[name].name == jnet.modules[name].name == name
            assert type(tnet.modules[name]).__name__ == type(jnet.modules[name]).__name__

        assert [(n, type(m).__name__) for n, m in tnet.modules.items()] == \
            [(n, type(m).__name__) for n, m in jnet.modules.items()]
        assert [m.name for m in tnet.modules.values()] == names
        assert "nope" not in tnet.modules and tnet.modules.get("nope") is None

        with pytest.raises(KeyError):
            tnet.modules["nope"]


def testContainerModulesStillCallable():
    """Called, ``net.modules`` is ``nn.Module.modules()``: the net, then every
    descendant."""
    net = buildTransformerClassifier(50, 16, 32, nheads=2, nlayers=1, nclasses=3)

    walked = list(net.modules())
    assert walked == list(nn.Module.modules(net)) and walked[0] is net
    assert len(walked) > len(net.modules)
    assert sum(isinstance(m, T.MultiHeadAttention) for m in walked) == 1


def testNarrowVGGExportsWithModulesView(tmp_path):
    """``torch.export`` (through ``buildEngine``) of the narrow VGG still
    works, and its engine gives the eager net's output."""
    np.random.seed(25)
    net = _narrowVGG(T, TC, "he")
    x = torch.from_numpy(np.random.RandomState(26).randn(2, 3, 16, 16).astype(np.float32))

    net.evalMode()
    want = net(x).numpy()
    net.reset()

    got = buildEngine(net, (2, 3, 16, 16), str(tmp_path))(x).numpy()
    assert np.allclose(got, want, atol=1e-5)


# -- a training run that repeats -------------------------------------------------------

def testEmbeddingGradientSumsRepeatedTokens():
    """Each token's rows summed in f32 and rounded once, padding adding
    nothing, as an f64 sum rounded once; the result repeats exactly."""
    from puzzlelib_tpu_torch.ops.embed import embedBackwardParams

    rng = np.random.RandomState(27)
    indices = torch.from_numpy(rng.randint(-1, 6, size=(4, 50)).astype(np.int32))
    grad = torch.from_numpy(rng.randn(4, 50, 8).astype(np.float32)).to(torch.bfloat16)

    want = np.zeros((6, 8))
    np.add.at(want, indices.numpy().reshape(-1)[indices.numpy().reshape(-1) >= 0],
              (grad.float().numpy() * 0.5).reshape(-1, 8)[indices.numpy().reshape(-1) >= 0])

    runs = [embedBackwardParams(indices, grad, torch.zeros((6, 8), dtype=torch.bfloat16), 0.5) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert np.abs(runs[0].float().numpy() - want).max() <= 2 ** -8 * np.abs(want).max()


@pytest.mark.cuda
def testBf16TrainingRepeatsOnCard(monkeypatch):
    """The narrow classifier (flash attention, emb 64, 2 heads of 32) trained
    3 steps in bf16 with Adam, twice from the same weights: the same losses,
    bit for bit."""
    _needsCard()
    from puzzlelib_tpu_torch.cost import CrossEntropy
    from puzzlelib_tpu_torch.handlers import Trainer
    from puzzlelib_tpu_torch.optimizers import Adam

    monkeypatch.setattr(TConfig, "device", "cuda")
    monkeypatch.setattr(TConfig, "globalEvalMode", False)

    rng = np.random.RandomState(28)
    tokens = rng.randint(0, 50, size=(48, 16)).astype(np.int32)
    labels = rng.randint(0, 3, size=48).astype(np.int32)

    def run():
        np.random.seed(29)
        net = buildTransformerClassifier(50, 16, 64, nheads=2, nlayers=1, nclasses=3, attnAlgo="flash")
        net.calcMode(torch.bfloat16)
        opt = Adam(alpha=1e-3)
        opt.setupOn(net, useGlobalState=True)
        trainer = Trainer(net, CrossEntropy(maxlabels=3), opt, batchsize=16)

        losses = []
        trainer.onBatchFinish = lambda h: losses.append(h.cost.getError())
        np.random.seed(30)
        trainer.trainFromHost(tokens, labels, macroBatchSize=48)
        return losses

    first, second = run(), run()
    assert len(first) == 3 and np.isfinite(first).all()
    assert first == second
