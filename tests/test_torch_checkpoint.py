"""HDF5 checkpoints of nets and optimizer state against the JAX package.

The two packages write one file layout (``puzzlelib_tpu_torch/hdf.py``).
Each net below is written by one package (``save(..., withBlueprint=True)``)
and read by the other twice: into a net of the same architecture built
from another seed (``load``) and into a net rebuilt from the file's
blueprint (``blueprint.load``).  Every variable and attribute then holds
the writer's values bit for bit, and the forward agrees within 1e-5
relative in f32 and within the bf16 tier (5e-2) for the bf16 net, whose
stored values are bit-equal across the packages.  The nets: the
Sequential of ``tests/test_blueprint.py``, a Graph, LeNet, a narrow
ResNet (``assumeUniqueNames``), a narrow MoE trunk (a ``Pipeline`` of
``Graph`` stages with ``SwitchMoE``), a conv with batch norm (running
stats), a bf16 net, a bidirectional LSTM and an ``Embedder`` whose file
holds another vocabulary than the net it loads into.

The optimizer state round-trips within the port for the nine optimizers
in local and global state (tolerance 0), and crosses from the JAX package:
it saves after two steps, the port loads, and the third step agrees within
1e-5.  ``testlib/resumetrain.py`` runs in both packages on small MNIST
files; ``convertRnnCheckpoint`` gives the JAX package's file.  A child
process shows the port saving into an in-memory store with none of
``h5py``, ``ml_dtypes``, ``jax`` or ``puzzlelib_tpu`` loaded, and opening a
path without ``h5py`` raising an ``ImportError`` that names it."""

import contextlib
import io
import os
import re
import subprocess
import sys
from collections.abc import Mapping
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import blueprint as TBlueprint
from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import containers as TC
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch import optimizers as TOpt
from puzzlelib_tpu_torch.models import nets as TNets
from puzzlelib_tpu_torch.models.nets import resnet as TResnet
from puzzlelib_tpu_torch.modules.module import ModuleError
from puzzlelib_tpu_torch.tools import dataslice as Data
from puzzlelib_tpu_torch.tools import moeslice
from puzzlelib_tpu_torch.variable import Variable


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_BOUND, BF16_BOUND = 1e-5, 5e-2


def _jax():
    """The JAX package's pieces; the twins skip where it does not import, as
    on the card's machine."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    import ml_dtypes
    from puzzlelib_tpu import blueprint, containers, modules, optimizers, variable
    from puzzlelib_tpu.backend import gpuarray
    from puzzlelib_tpu.models import nets
    from puzzlelib_tpu.models.nets import resnet

    return SimpleNamespace(M=modules, C=containers, Nets=nets, Resnet=resnet, Blueprint=blueprint, Opt=optimizers,
                           Variable=variable.Variable, bf16=np.dtype(ml_dtypes.bfloat16).type,
                           upload=gpuarray.to_gpu, host=lambda t: np.asarray(t.get()))


def _port():
    return SimpleNamespace(M=T, C=TC, Nets=TNets, Resnet=TResnet, Blueprint=TBlueprint, Opt=TOpt, Variable=Variable,
                           bf16=torch.bfloat16, upload=lambda a: torch.from_numpy(np.ascontiguousarray(a)),
                           host=lambda t: t.detach().float().numpy() if t.dtype == torch.bfloat16 else
                           t.detach().numpy())


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _close(got, want, bound):
    got, want = np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def _bits(value):
    """A variable's or attribute's stored bits as a host array: bf16 as
    uint16, the rest as they are."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        return value.view(torch.int16).numpy().view(np.uint16) if value.dtype == torch.bfloat16 else value.numpy()

    value = np.asarray(value.get() if hasattr(value, "get") else value)
    return value.view(np.uint16) if value.dtype.itemsize == 2 and value.dtype.kind == "V" or \
        value.dtype.name == "bfloat16" else value


def _varBits(net):
    return {name: _bits(var.data) for var, names in net.getVarTable().items() for name in names}


# -- the nets --------------------------------------------------------------------------------------

def _sequential(P, role):
    seq = P.C.Sequential()
    seq.append(P.M.Linear(20, 10, name="linear-1"))
    seq.append(P.M.Activation(P.M.relu, name="relu-1"))
    seq.append(P.M.Linear(10, 5, name="linear-2"))
    seq.append(P.M.Activation(P.M.relu, name="relu-2"))
    seq.append(P.M.Replicate(times=2, name="repl"))
    seq.append(P.C.Parallel().append(P.M.Linear(5, 2, name="linear-3-1")).append(P.M.Linear(5, 3, name="linear-3-2")))
    seq.append(P.M.Concat(axis=1, name="concat"))
    return seq


def _graph(P, role):
    inp = P.M.Linear(20, 10, name="linear-1").node()
    h = P.M.Activation(P.M.relu, name="relu-1").node(inp)
    h1 = P.M.Linear(10, 5, name="linear-2").node(h)
    h2 = P.M.Linear(10, 5, name="linear-3").node(h)
    return P.C.Graph(inputs=inp, outputs=P.M.Concat(axis=1, name="concat").node(h1, h2))


def _lenet(P, role):
    return P.Nets.loadLeNet(None, initscheme=None)


def _resnet(P, role):
    """A stem conv with its batch norm, then two bottleneck blocks at widths
    8 and 16 (the second strided), as ``tests/test_torch_resnet.py``'s
    narrow net; its names repeat across blocks, hence ``assumeUniqueNames``."""
    net = P.C.Sequential(name="narrow")
    net.append(P.M.Conv2D(3, 8, 3, pad=1, useBias=False, initscheme="he", name="conv1"))
    net.append(P.M.BatchNorm2D(8, name="bn_conv1"))
    net.append(P.M.Activation(P.M.relu, name="conv1_relu"))
    net.extend(P.Resnet.residBlock(8, 8, 1, "2a", True, False, False, "he"))
    net.extend(P.Resnet.residBlock(32, 16, 2, "3a", True, False, False, "he"))
    net.append(P.M.AvgPool2D(8, 1))
    net.append(P.M.Flatten())
    net.append(P.M.Linear(64, 10, initscheme="he", name="fc"))
    return net


def _moe(P, role):
    pipe = P.C.Pipeline(name="trunk")
    for index in range(2):
        pipe.append(moeslice.makeStage(index, dim=16, experts=2, modules=P.M, containers=P.C))
    return pipe


def _convBn(P, role):
    net = P.C.Sequential()
    net.append(P.M.Conv2D(3, 8, 3, pad=1, name="conv"))
    net.append(P.M.BatchNorm2D(8, name="bn"))
    return net


def _bf16(P, role):
    net = P.C.Sequential()
    net.append(P.M.Conv2D(3, 8, 3, pad=1, name="conv"))
    net.append(P.M.Flatten())
    net.append(P.M.Linear(8 * 36, 4, name="fc2d"))
    net.calcMode(P.bf16)
    return net


def _rnn(P, role):
    net = P.C.Sequential(name="rnn")
    net.append(P.M.RNN(6, 5, layers=2, mode="lstm", direction="bi", getSequences=True, name="lstm"))
    return net


def _embedder(P, role):
    """The writer's vocabulary has 12 words; the net the file loads into was
    built for 8: the load makes its W anew at 12 rows."""
    vocabulary = {"w%d" % i: i for i in range(12)} if role == "source" else 8
    net = P.C.Sequential(name="emb")
    net.append(P.M.Embedder(vocabulary, sentlength=5, embsize=4, name="embedder"))
    return net


NETS = {
    # name: (builder, input of the forward, assumeUniqueNames, bound, input in the net's type)
    "sequential": (_sequential, lambda rng: rng.randn(4, 20).astype(np.float32), False, F32_BOUND),
    "graph": (_graph, lambda rng: rng.randn(4, 20).astype(np.float32), False, F32_BOUND),
    "lenet": (_lenet, lambda rng: rng.rand(2, 1, 28, 28).astype(np.float32), False, F32_BOUND),
    "resnet": (_resnet, lambda rng: rng.randn(2, 3, 16, 16).astype(np.float32), True, F32_BOUND),
    "moe": (_moe, lambda rng: rng.randn(8, 16).astype(np.float32), False, F32_BOUND),
    "batchnorm": (_convBn, lambda rng: rng.randn(2, 3, 6, 6).astype(np.float32), False, F32_BOUND),
    "bf16": (_bf16, lambda rng: rng.randn(2, 3, 6, 6).astype(np.float32), False, BF16_BOUND),
    "rnn": (_rnn, lambda rng: rng.randn(7, 3, 6).astype(np.float32), False, F32_BOUND),
    "embedder": (_embedder, lambda rng: rng.randint(0, 12, size=(3, 5)).astype(np.int32), False, F32_BOUND),
}


def _forward(P, net, x):
    """The net's output on ``x`` as f32 host values; ``x`` is cast to bf16
    for a bf16 net."""
    lead = next(iter(net.getVarTable())).data
    if str(lead.dtype).endswith("bfloat16"):
        inp = P.upload(x).to(torch.bfloat16) if P.bf16 is torch.bfloat16 else P.upload(x.astype(P.bf16))
    else:
        inp = P.upload(x)

    out = net(inp)
    result = P.host(out).astype(np.float32)
    net.reset()
    return result


def _advanceStats(P, net, x):
    """A train-mode forward, which moves the batch norms' running stats off
    their start, so the file's attributes carry something."""
    net.trainMode()
    net(P.upload(x))
    net.reset()


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("kind", list(NETS))
def testCheckpointCrossesPackages(kind, direction, tmp_path):
    """The writer's net saved with its blueprint; the reader loads it into a
    net built from another seed and rebuilds one from the blueprint: the
    variables and attributes equal the writer's bit for bit (a bf16 file's
    bf16 values too), and both forwards agree with the writer's."""
    J, P = _jax(), _port()
    src, dst = (J, P) if direction == "jax-to-port" else (P, J)
    build, data, unique, bound = NETS[kind]
    x = data(np.random.RandomState(5))

    np.random.seed(1)
    net = build(src, "source")
    if kind in ("resnet", "batchnorm"):
        _advanceStats(src, net, x)
    net.evalMode()
    want = _forward(src, net, x)

    path = str(tmp_path / "net.hdf")
    net.save(path, withBlueprint=True, assumeUniqueNames=unique)

    np.random.seed(2)
    other = build(dst, "target")
    other.evalMode()
    other.load(path, assumeUniqueNames=unique)

    rebuilt = dst.Blueprint.load(path, assumeUniqueNames=unique)
    rebuilt.evalMode()

    # a child a container named on append ("0", "1", ...) has no name in its
    # blueprint, and the rebuilt container names it anew: the rebuilt net's
    # tables are compared in order, the other net's by name
    for table in (_varBits, _attrBits):
        written = table(net)
        byName, inOrder = table(other), table(rebuilt)
        assert sorted(byName) == sorted(written) and len(inOrder) == len(written)

        for (name, value), again in zip(written.items(), inOrder.values()):
            assert np.array_equal(byName[name], value), name
            if value.dtype == np.uint16 and again.dtype == np.float32:
                # the rebuilt net is f32: it holds the bf16 values exactly
                value = (value.astype(np.uint32) << 16).view(np.float32)
            assert np.array_equal(again, value), name

    if kind == "embedder":
        assert other["embedder"].W.shape[0] == 12
        assert [bytes(w) if isinstance(w, bytes) else w.encode() for w in other["embedder"].vocab] == \
            [("w%d" % i).encode() for i in range(12)]

    _close(_forward(dst, other, x), want, bound)
    _close(_forward(dst, rebuilt, x), want, bound)


def _leaves(net, prefix=None):
    """(path, leaf module) of a net of either package, depth first: a
    container's ``modules`` is a mapping of its children."""
    for child in net.modules.values():
        path = child.name if prefix is None else "%s.%s" % (prefix, child.name)
        if isinstance(getattr(child, "modules", None), Mapping):
            yield from _leaves(child, path)
        else:
            yield path, child


def _attrBits(net):
    """The tensor attributes of every leaf (the batch norms' running stats)
    by path, as stored bits."""
    return {"%s.%s" % (path, name): _bits(attr) for path, mod in _leaves(net) for name, attr in mod.attrs.items()
            if hasattr(attr, "shape") and getattr(attr, "dtype", None) != object}


# -- the rules of a load ---------------------------------------------------------------------------

def _linearNet(P, calc=None):
    net = P.C.Sequential(name="net")
    net.append(P.M.Linear(6, 3, name="fc"))
    if calc is not None:
        net.calcMode(calc)
    return net


def testLoadCastsSafelyOnlyTwin(tmp_path):
    """numpy's ``casting="safe"``, bf16 known by its tag: an f32 file into a
    bf16 net raises ``ModuleError`` in both packages; a bf16 file loads into
    an f32 net, each value exact."""
    J, P = _jax(), _port()
    f32Path, bf16Path = str(tmp_path / "f32.hdf"), str(tmp_path / "bf16.hdf")
    np.random.seed(3)
    _linearNet(P).save(f32Path)
    np.random.seed(3)
    bf16Net = _linearNet(P, torch.bfloat16)
    bf16Net.save(bf16Path)

    from puzzlelib_tpu.modules.module import ModuleError as JModuleError
    for M, error in ((P, ModuleError), (J, JModuleError)):
        with pytest.raises(error, match="safe"):
            _linearNet(M, M.bf16).load(f32Path)

    for M in (P, J):
        net = _linearNet(M)
        net.load(bf16Path)
        want = _bits(bf16Net["fc"].W).astype(np.uint32) << 16
        assert np.array_equal(_bits(net["fc"].W).view(np.uint32), want)


def testLoadWritesInPlaceUnderGlobalState(tmp_path):
    """After ``setupOn(..., useGlobalState=True)`` the variables are views of
    the optimizer's flat buffer: a load writes through them, every tensor
    keeps its address, and the flat buffer holds the file's values."""
    P = _port()
    path = str(tmp_path / "net.hdf")
    np.random.seed(4)
    source = _lenet(P, "source")
    source.save(path)

    np.random.seed(5)
    net = _lenet(P, "target")
    opt = TOpt.MomentumSGD(0.1, 0.9)
    opt.setupOn(net, useGlobalState=True)
    addresses = {name: var.data.data_ptr() for var, names in net.getVarTable().items() for name in names}

    net.load(path)

    shared = opt.shParams[torch.float32]
    for var, names in net.getVarTable().items():
        assert var.data.data_ptr() == addresses[names[0]] == shared[names[0]].data_ptr()
        assert torch.equal(shared[names[0]], source.getVar(names[0]).data), names[0]


def testSharedVariableIsStoredOnceTwin(tmp_path):
    """Two modules sharing one variable (tied weights) store it once
    (``params/0`` only, two links), in either package, and load back
    into both."""
    import h5py

    J, P = _jax(), _port()
    for src, dst in ((P, J), (J, P)):
        np.random.seed(6)
        net = src.C.Sequential(name="tied")
        first, second = src.M.Linear(4, 4, name="a"), src.M.Linear(4, 4, name="b")
        second.setVar("W", first.getVar("W"))
        net.append(first).append(second)

        path = str(tmp_path / "tied.hdf")
        net.save(path)
        with h5py.File(path, "r") as hdf:
            assert sorted(hdf["params"]) == ["0", "1", "2"] and hdf["links"]["tied.a.W"][()] == \
                hdf["links"]["tied.b.W"][()]

        np.random.seed(7)
        other = dst.C.Sequential(name="tied")
        other.append(dst.M.Linear(4, 4, name="a")).append(dst.M.Linear(4, 4, name="b"))
        other.load(path)
        assert np.array_equal(_bits(other["a"].W), _bits(first.W))
        assert np.array_equal(_bits(other["b"].W), _bits(first.W))


def testContainerAttributesTwin(tmp_path):
    """A container's host attributes (a preset's sentence length and
    padding) go in ``attrs.<name>`` as "<name>.<attr>" and come back in
    either package."""
    J, P = _jax(), _port()
    for src, dst in ((P, J), (J, P)):
        np.random.seed(8)
        net = _linearNet(src)
        net.setAttr("sentlength", 100)
        net.setAttr("padding", 4)
        path = str(tmp_path / "attrs.hdf")
        net.save(path)

        other = _linearNet(dst)
        other.load(path)
        if dst is P:
            assert (other.sentlength, other.padding) == (100, 4) and other.hostAttrs == {"sentlength": 100,
                                                                                         "padding": 4}
        else:
            assert {k: int(v) for k, v in other.attrs.items()} == {"net.sentlength": 100, "net.padding": 4}


def testModuleErrorNamesThePath(tmp_path):
    """A file without the module's variable fails with the reference's
    message: the container, its path and the cause."""
    P = _port()
    path = str(tmp_path / "net.hdf")
    _linearNet(P).save(path)

    other = P.C.Sequential(name="net")
    other.append(P.M.Linear(6, 3, name="other"))
    with pytest.raises(ModuleError, match="Container net load error: Module net.other load error"):
        other.load(path)


# -- optimizer state -------------------------------------------------------------------------------

# name: constructor arguments
OPTIMIZERS = {
    "SGD": dict(learnRate=0.1), "MomentumSGD": dict(learnRate=0.1, momRate=0.9),
    "NesterovSGD": dict(learnRate=0.1, momRate=0.9), "Adam": dict(alpha=0.01),
    "AdaGrad": dict(learnRate=0.1, epsilon=1e-8), "AdaDelta": dict(rho=0.95, epsilon=1e-6),
    "RMSProp": dict(learnRate=0.01, factor=0.9, epsilon=1e-5),
    "RMSPropGraves": dict(learnRate=1e-4, alpha=0.95, momRate=0.9, epsilon=1e-4),
    "SMORMS3": dict(learnRate=1e-3, epsilon=1e-16),
}


class _OneVarModule:
    """The module protocol's stand-in of ``tests/test_optimizers.py``: one
    variable named "w", of either package."""

    def __init__(self, var):
        self.var = var

    def getVarTable(self):
        return {self.var: ["w"]}

    def getVar(self, name):
        return self.var

    def setVar(self, name, var):
        self.var = var


def _grads(steps, shape=(7, 5)):
    return [np.random.RandomState(1 + i).randn(*shape).astype(np.float32) for i in range(steps)]


def _run(P, name, w, grads, useGlobalState):
    """``name`` of package ``P`` set up on one variable ``w`` and stepped
    once per gradient: (module, optimizer)."""
    mod = _OneVarModule(P.Variable(P.upload(w.copy()), grad=P.upload(np.zeros_like(w))))
    opt = getattr(P.Opt, name)(**OPTIMIZERS[name])
    opt.setupOn(mod, useGlobalState=useGlobalState)
    for g in grads:
        _step(P, mod, opt, g)
    return mod, opt


def _step(P, mod, opt, g):
    grad = mod.getVar("w").grad
    grad.copy_(torch.from_numpy(g)) if isinstance(grad, torch.Tensor) else grad.set(g)
    opt.update()


def _states(opt):
    return {(str(key), entity): _bits(tensor).copy() for key, state in opt.states.items()
            for entity, tensor in state.items()}


@pytest.mark.parametrize("useGlobalState", [False, True])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def testOptimizerStateSaveLoadTwin(name, useGlobalState, tmp_path):
    """``testOptimizerStateSaveLoad`` for each optimizer: three steps, save;
    a fresh optimizer one step, load: ``t``, every attribute and every state
    tensor equal the saved ones bit for bit, each state tensor keeps its
    address, and the next step gives the saved optimizer's weights."""
    P = _port()
    w, grads = np.random.RandomState(0).randn(7, 5).astype(np.float32), _grads(4)

    mod, opt = _run(P, name, w, grads[:3], useGlobalState)
    path = str(tmp_path / "opt.hdf")
    opt.save(path)

    mod2, opt2 = _run(P, name, w, grads[:1], useGlobalState)
    addresses = {(key, entity): t.data_ptr() for key, state in opt2.states.items() for entity, t in state.items()}
    opt2.load(path)

    assert opt2.t == opt.t == 3
    assert opt2.getAttrDict() == opt.getAttrDict()
    assert {key: value.tolist() for key, value in _states(opt2).items()} == \
        {key: value.tolist() for key, value in _states(opt).items()}
    assert {(key, entity): t.data_ptr() for key, state in opt2.states.items() for entity, t in state.items()} == \
        addresses

    mod2.getVar("w").data.copy_(mod.getVar("w").data)
    _step(P, mod, opt, grads[3])
    _step(P, mod2, opt2, grads[3])
    assert torch.equal(mod2.getVar("w").data, mod.getVar("w").data)


@pytest.mark.parametrize("useGlobalState", [False, True])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def testOptimizerStateFromJax(name, useGlobalState, tmp_path):
    """The JAX package's optimizer steps twice and saves; the port's, set up
    on the JAX weights after those steps, loads the file (the state names
    are the JAX package's: "w.<entity>" or "<class 'numpy.float32'>.<entity>")
    and takes the third step: weights and states within 1e-5 of the JAX
    package's third step."""
    J, P = _jax(), _port()
    w, grads = np.random.RandomState(0).randn(7, 5).astype(np.float32), _grads(3)

    jmod, jopt = _run(J, name, w, grads[:2], useGlobalState)
    path = str(tmp_path / "opt.hdf")
    jopt.save(path)

    tmod, topt = _run(P, name, J.host(jmod.getVar("w").data), [], useGlobalState)
    topt.load(path)
    assert topt.t == 2

    _step(J, jmod, jopt, grads[2])
    _step(P, tmod, topt, grads[2])

    _close(tmod.getVar("w").data.numpy(), J.host(jmod.getVar("w").data), F32_BOUND)
    want = {(str(key) if not useGlobalState else "flat", entity): J.host(t) for key, state in jopt.states.items()
            for entity, t in state.items()}
    got = {(str(key) if not useGlobalState else "flat", entity): t.numpy() for key, state in topt.states.items()
           for entity, t in state.items()}
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        _close(got[key], value, F32_BOUND)


def testBf16OptimizerStateFromJax(tmp_path):
    """A bf16 state the JAX package saves untagged (its ``ml_dtypes`` array,
    an opaque 2-byte dataset) loads into the port's bf16 state bit for
    bit."""
    J, P = _jax(), _port()
    w = np.random.RandomState(0).randn(7, 5).astype(np.float32)
    g = np.random.RandomState(1).randn(7, 5).astype(np.float32)

    jmod = _OneVarModule(J.Variable(J.upload(w.astype(J.bf16)), grad=J.upload(np.zeros_like(w).astype(J.bf16))))
    jopt = J.Opt.MomentumSGD(0.1, 0.9)
    jopt.setupOn(jmod, useGlobalState=False)
    jmod.getVar("w").grad.set(g.astype(J.bf16))
    jopt.update()
    path = str(tmp_path / "opt.hdf")
    jopt.save(path)

    zeros = torch.zeros(7, 5, dtype=torch.bfloat16)
    tmod = _OneVarModule(Variable(zeros.clone(), grad=zeros.clone()))
    topt = TOpt.MomentumSGD(0.1, 0.9)
    topt.setupOn(tmod, useGlobalState=False)
    topt.load(path)

    assert topt.t == 1
    assert np.array_equal(_bits(topt.states["w"]["mom"]), _bits(jopt.states["w"]["mom"]))


# -- the scripts and converters --------------------------------------------------------------------

class _Split:
    """A loaded array whose rows 60000 on, as ``resumetrain`` slices them,
    start at ``split``: the scripts' train / validation split on small
    files."""

    def __init__(self, array, split):
        self.array, self.split = array, split

    def __getitem__(self, item):
        if item == slice(None):
            return self

        bound = lambda v: self.split if v == 60000 else v
        return self.array[slice(bound(item.start), bound(item.stop))]


def testResumeTrainMainTwin(tmp_path, monkeypatch):
    """``resumetrain.main`` of both packages on the same small MNIST idx
    files (48 training and 16 test images), the 60000-row split moved to
    the file's 16 + 32 rows, one epoch before and one after the reload:
    the same printed train errors and accuracies within 1e-5, and the
    files removed at the end."""
    _jax()
    from testlib import resumetrain as JResume
    from puzzlelib_tpu_torch.testlib import resumetrain as TResume

    printed = {}
    for name, script in (("jax", JResume), ("port", TResume)):
        path = tmp_path / name
        path.mkdir()
        Data.writeMnist(str(path), train=48, test=16, seed=3)

        class Loader(script.MnistLoader):
            def load(self, *args, **kwargs):
                data, labels = super().load(*args, **kwargs)
                return _Split(data, 48), _Split(labels, 48)

        monkeypatch.setattr(script, "MnistLoader", Loader)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            script.main(epochs=1, datapath=str(path))
        printed[name] = out.getvalue()

        assert not os.path.exists(path / "net.hdf") and not os.path.exists(path / "optimizer.hdf")

    numbers = {name: [float(v) for v in re.findall(r"(?:Train error|Accuracy): (\S+)", text)]
               for name, text in printed.items()}
    assert len(numbers["port"]) == 4, printed["port"]
    assert np.allclose(numbers["port"], numbers["jax"], rtol=F32_BOUND, atol=0.0), numbers


@pytest.mark.parametrize("source", ["cudnn", "native"])
def testConvertRnnCheckpointTwin(source, tmp_path):
    """``convertRnnCheckpoint`` of both packages on one file that the JAX
    package's RNN wrote: the two converted files hold the same bytes in
    every dataset, and the port's RNN loads the converted weights."""
    J, P = _jax(), _port()
    from puzzlelib_tpu.converter.rnnweights import convertRnnCheckpoint as jconvert
    from puzzlelib_tpu_torch.converter.rnnweights import convertRnnCheckpoint as tconvert
    import h5py

    np.random.seed(9)
    net = J.C.Sequential(name="rnn")
    net.append(J.M.RNN(6, 5, layers=2, mode="lstm", direction="bi", name="lstm"))
    path = str(tmp_path / "rnn.hdf")
    net.save(path)

    outs = {}
    for name, convert in (("jax", jconvert), ("port", tconvert)):
        outs[name] = str(tmp_path / ("%s.hdf" % name))
        assert convert(path, outs[name], "lstm", 6, 5, 2, direction="bi", source=source) == outs[name]

    with h5py.File(outs["jax"], "r") as jf, h5py.File(outs["port"], "r") as tf, h5py.File(path, "r") as orig:
        assert sorted(tf["params"]) == sorted(jf["params"])
        for key in jf["params"]:
            assert np.array_equal(np.asarray(tf["params"][key]), np.asarray(jf["params"][key]))
        assert not np.array_equal(np.asarray(tf["params"]["0"]), np.asarray(orig["params"]["0"]))

    np.random.seed(10)
    port = P.C.Sequential(name="rnn")
    port.append(P.M.RNN(6, 5, layers=2, mode="lstm", direction="bi", name="lstm"))
    port.load(outs["port"])
    with h5py.File(outs["jax"], "r") as jf:
        assert np.array_equal(port["lstm"].W.numpy().reshape(-1), np.asarray(jf["params"]["0"]).reshape(-1))


# -- import hygiene --------------------------------------------------------------------------------

_HYGIENE = r'''
import json, sys
import numpy as np
from puzzlelib_tpu_torch import config
config.device = "cpu"
from puzzlelib_tpu_torch.models.nets import loadLeNet
from puzzlelib_tpu_torch.optimizers import MomentumSGD


class Store:
    """An in-memory store: the calls the codec makes on an h5py group."""

    def __init__(self):
        self.items_, self.attrs, self.value = {}, {}, None

    def require_group(self, name):
        return self.items_.setdefault(name, Store())

    def create_dataset(self, name, data=None, compression=None):
        ds = self.items_[name] = Store()
        ds.value = np.array(data)
        return ds

    def __getitem__(self, key):
        return self.value[key] if key == () else self.items_[key]

    def __setitem__(self, key, value):
        self.create_dataset(key, data=value)

    def __contains__(self, key):
        return key in self.items_

    def items(self):
        return self.items_.items()

    def __array__(self, dtype=None, copy=None):
        return self.value


np.random.seed(0)
net = loadLeNet(None, initscheme=None)
opt = MomentumSGD(0.1, 0.9)
opt.setupOn(net, useGlobalState=True)
blueprint = json.dumps(net.getBlueprint(), sort_keys=True)
store, optStore = Store(), Store()
net.save(store)
opt.save(optStore)

other = loadLeNet(None, initscheme=None)
other.load(store)
assert all(np.array_equal(var.data.numpy(), other.getVar(names[0]).data.numpy())
           for var, names in net.getVarTable().items())
again = MomentumSGD(0.1, 0.9)
again.setupOn(other, useGlobalState=True)
again.load(optStore)
assert again.t == opt.t

print(json.dumps({"loaded": sorted(m for m in ("h5py", "ml_dtypes", "jax", "puzzlelib_tpu") if m in sys.modules),
                  "links": len(store["links"].items_), "blueprint": len(blueprint)}))

sys.modules["h5py"] = None
try:
    net.save("net.hdf")
except Exception as e:
    print(json.dumps({"error": type(e).__name__, "message": str(e)}))
'''


def testPortSavesWithoutH5pyOrJax(tmp_path):
    """In a child process: the port builds LeNet, its blueprint, and saves
    and loads the net (and saves its optimizer) through an in-memory store
    of its own; none of ``h5py``, ``ml_dtypes``, ``jax`` or ``puzzlelib_tpu``
    is loaded then.  With ``h5py`` unimportable, saving to a path fails with
    an error naming h5py."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    result = subprocess.run([sys.executable, "-c", _HYGIENE], cwd=str(tmp_path), env=env, capture_output=True,
                            text=True, timeout=300)
    assert result.returncode == 0, result.stderr

    import json
    lines = [json.loads(line) for line in result.stdout.splitlines()]
    assert lines[0]["loaded"] == [] and lines[0]["links"] == 8 and lines[0]["blueprint"] > 0
    assert lines[1]["error"] == "ImportError" and "h5py" in lines[1]["message"]


def testOpeningAPathWithoutH5pyRaisesImportError(monkeypatch):
    """``hdf.openStore`` on a path or an image, with ``h5py`` unimportable:
    an ``ImportError`` naming it, never another format."""
    from puzzlelib_tpu_torch import hdf

    monkeypatch.setitem(sys.modules, "h5py", None)
    for target in ("net.hdf", b"image", None):
        with pytest.raises(ImportError, match="h5py"):
            hdf.openStore(target, "r")
