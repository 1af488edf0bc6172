"""Blueprints: the port's twins of ``tests/test_blueprint.py`` and the
blueprints of both packages held equal.

The five round trips of ``tests/test_blueprint.py`` run in the port
(tolerance 0: a round trip within one package is exact): a file, a memory
image, a Graph, a conv with batch norm and a bf16 checkpoint.  Every module
class of ``puzzlelib_tpu_torch.modules`` records the JAX package's
blueprint, key for key under ``json.dumps(..., sort_keys=True)``, and both
factories rebuild it alike from the JSON (or both refuse it, as they refuse
a ``MaxUnpool2D``, whose pool is not recorded, or a ``MoEGate``, which
neither package's modules export; the JAX package does not export
``LRN``, which only the port's factory builds).  So do the nets that the
other twins build at narrow size: AlexNet, C3D, SegNet, the transformer
classifier, SentiNet, the IMDB nets and the MoE trunk."""

import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import blueprint as TBlueprint
from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import containers as TC
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.models import nets as TNets
from puzzlelib_tpu_torch.tools import alexnetslice, c3dslice, moeslice, segslice
from puzzlelib_tpu_torch.tools import sequenceslice as Seq


def _jax():
    """The JAX package's pieces; the twins skip where it does not import, as
    on the card's machine."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    import ml_dtypes
    from puzzlelib_tpu import blueprint, containers, modules
    from puzzlelib_tpu.models import nets

    return SimpleNamespace(M=modules, C=containers, Nets=nets, Blueprint=blueprint,
                           bf16=np.dtype(ml_dtypes.bfloat16).type)


PORT = SimpleNamespace(M=T, C=TC, Nets=TNets, Blueprint=TBlueprint, bf16=torch.bfloat16)


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card."""
    monkeypatch.setattr(TConfig, "device", "cpu")
    monkeypatch.setattr(TConfig, "globalEvalMode", False)


def _json(net):
    return json.dumps(net.getBlueprint(), sort_keys=True)


# -- the twins of tests/test_blueprint.py --------------------------------------------------------

def buildNet():
    seq = TC.Sequential()

    seq.append(T.Linear(20, 10, name="linear-1"))
    seq.append(T.Activation(T.relu, name="relu-1"))

    seq.append(T.Linear(10, 5, name="linear-2"))
    seq.append(T.Activation(T.relu, name="relu-2"))

    seq.append(T.Replicate(times=2, name="repl"))
    seq.append(TC.Parallel().append(T.Linear(5, 2, name="linear-3-1")).append(T.Linear(5, 3, name="linear-3-2")))
    seq.append(T.Concat(axis=1, name="concat"))

    return seq


def testBlueprintFileRoundTrip(tmp_path):
    np.random.seed(0)
    net = buildNet()

    path = str(tmp_path / "net.hdf")
    net.save(path, withBlueprint=True)

    rebuilt = TBlueprint.load(path)

    data = torch.from_numpy(np.random.randn(4, 20).astype(np.float32))
    assert torch.equal(net(data), rebuilt(data))


def testBlueprintMemoryRoundTrip():
    np.random.seed(1)
    net = buildNet()

    buffer = net.save(withBlueprint=True)
    assert isinstance(buffer, bytes)

    rebuilt = TBlueprint.load(buffer)

    data = torch.from_numpy(np.random.randn(4, 20).astype(np.float32))
    assert torch.equal(net(data), rebuilt(data))


def testBlueprintGraphRoundTrip(tmp_path):
    np.random.seed(2)

    inp = T.Linear(20, 10, name="linear-1").node()
    h = T.Activation(T.relu, name="relu-1").node(inp)

    h1 = T.Linear(10, 5, name="linear-2").node(h)
    h2 = T.Linear(10, 5, name="linear-3").node(h)

    output = T.Concat(axis=1, name="concat").node(h1, h2)
    graph = TC.Graph(inputs=inp, outputs=output)

    path = str(tmp_path / "graph.hdf")
    graph.save(path, withBlueprint=True)

    rebuilt = TBlueprint.load(path)

    data = torch.from_numpy(np.random.randn(4, 20).astype(np.float32))
    assert torch.equal(graph(data), rebuilt(data))


def testConvBnBlueprint(tmp_path):
    np.random.seed(3)

    net = TC.Sequential()
    net.append(T.Conv2D(3, 8, 3, pad=1, name="conv"))
    net.append(T.BatchNorm2D(8, name="bn"))

    net.trainMode()
    data = torch.from_numpy(np.random.randn(2, 3, 6, 6).astype(np.float32))
    net(data)  # advance running stats

    path = str(tmp_path / "convbn.hdf")
    net.save(path, withBlueprint=True)

    rebuilt = TBlueprint.load(path)
    rebuilt.evalMode()
    net.evalMode()

    assert torch.equal(rebuilt["bn"].mean, net["bn"].mean) and torch.equal(rebuilt["bn"].var, net["bn"].var)
    assert torch.equal(net(data), rebuilt(data))


def testBf16CheckpointRoundTrip(tmp_path):
    """bfloat16 params survive save/load: HDF5 has no native bf16, so the
    codec stores the raw bits, opaque, tagged with a ``dtype`` attribute."""
    import h5py

    np.random.seed(4)

    def build():
        net = TC.Sequential()
        net.append(T.Conv2D(3, 8, 3, pad=1, name="conv"))
        net.append(T.Linear(8 * 36, 4, name="fc2d"))
        return net

    net = build()
    net.calcMode(torch.bfloat16)

    path = str(tmp_path / "bf16.hdf")
    net.save(path)

    with h5py.File(path, "r") as hdf:
        stored = hdf["params"]["0"]
        assert stored.dtype == np.dtype("V2") and stored.attrs["dtype"] == "bfloat16"

    other = build()
    other.calcMode(torch.bfloat16)
    other.load(path)

    for mod in ("conv", "fc2d"):
        assert other[mod].W.dtype == torch.bfloat16
        assert torch.equal(net[mod].W.view(torch.int16), other[mod].W.view(torch.int16))


# -- every module's blueprint against the JAX package's ---------------------------------------------

def _unpool(P):
    return P.M.MaxUnpool2D(P.M.MaxPool2D(useMask=True), name="unpool")


MODULES = {
    "Activation": lambda P: P.M.Activation(P.M.leakyRelu, args=(0.1, ), name="act"),
    "Add": lambda P: P.M.Add(),
    "AvgPool1D": lambda P: P.M.AvgPool1D(3, 2, pad=1, includePad=False),
    "AvgPool2D": lambda P: P.M.AvgPool2D(3, 2, pad=1),
    "AvgPool3D": lambda P: P.M.AvgPool3D(),
    "BatchNorm": lambda P: P.M.BatchNorm(6, epsilon=1e-3),
    "BatchNorm1D": lambda P: P.M.BatchNorm1D(4),
    "BatchNorm2D": lambda P: P.M.BatchNorm2D(4, name="bn"),
    "BatchNorm3D": lambda P: P.M.BatchNorm3D(4, affine=False),
    "Cast": lambda P: P.M.Cast("float32", "bfloat16"),
    "Cast-numpy": lambda P: P.M.Cast(np.float32, np.float16),
    "Concat": lambda P: P.M.Concat(axis=1),
    "Conv1D": lambda P: P.M.Conv1D(2, 3, 3, pad=1, initscheme="he"),
    "Conv2D": lambda P: P.M.Conv2D(2, 3, 3, stride=2, dilation=1, useBias=False, initscheme=("xavier", "avg")),
    "Conv3D": lambda P: P.M.Conv3D(2, 3, 3, groups=1),
    "CrossMapLRN": lambda P: P.M.CrossMapLRN(N=3),
    "Deconv1D": lambda P: P.M.Deconv1D(3, 2, 3),
    "Deconv2D": lambda P: P.M.Deconv2D(3, 2, 3, stride=2, postpad=1),
    "Deconv3D": lambda P: P.M.Deconv3D(3, 2, 3),
    "DepthConcat": lambda P: P.M.DepthConcat(),
    "Dropout": lambda P: P.M.Dropout(p=0.3),
    "Dropout2D": lambda P: P.M.Dropout2D(p=0.2),
    "Embedder": lambda P: P.M.Embedder({"a": 0, "b": 1, "c": 2}, sentlength=4, embsize=3),
    "Flatten": lambda P: P.M.Flatten(),
    "Gelu": lambda P: P.M.Gelu(),
    "Glue": lambda P: P.M.Glue(),
    "GroupLinear": lambda P: P.M.GroupLinear(2, 4, 3),
    "Identity": lambda P: P.M.Identity(),
    "InstanceNorm2D": lambda P: P.M.InstanceNorm2D(4),
    "KMaxPool": lambda P: P.M.KMaxPool(topk=2, axis=1),
    "LCN": lambda P: P.M.LCN(),
    "LRN": lambda P: importlib.import_module(P.M.__name__ + ".lrn").LRN(N=3),
    "LayerNorm": lambda P: P.M.LayerNorm(4),
    "Linear": lambda P: P.M.Linear(4, 3, initscheme="gaussian", wscale=0.5, name="fc"),
    "MapLRN": lambda P: P.M.MapLRN(),
    "MaxPool1D": lambda P: P.M.MaxPool1D(),
    "MaxPool2D": lambda P: P.M.MaxPool2D(useMask=True),
    "MaxPool3D": lambda P: P.M.MaxPool3D(),
    "MaxUnpool2D": _unpool,
    "MoEGate": lambda P: P.M.MoEGate(8, 2),
    "MoveAxis": lambda P: P.M.MoveAxis(1, 2),
    "Mul": lambda P: P.M.Mul(),
    "MulAddConst": lambda P: P.M.MulAddConst(a=2.0, b=1.0),
    "MultiHeadAttention": lambda P: P.M.MultiHeadAttention(16, 4, causal=True),
    "NoiseInjector": lambda P: P.M.NoiseInjector(mode="mul", noisetype="gaussian", params=(1.0, 0.1)),
    "Pad1D": lambda P: P.M.Pad1D(pad=(1, 2)),
    "Pad2D": lambda P: P.M.Pad2D(pad=(1, 1, 2, 2), mode="reflect"),
    "PRelu": lambda P: P.M.PRelu(4),
    "Penalty": lambda P: P.M.Penalty(mode="l2", weight=1e-3),
    "RNN": lambda P: P.M.RNN(4, 3, mode="lstm", direction="bi"),
    "Replicate": lambda P: P.M.Replicate(times=2),
    "Reshape": lambda P: P.M.Reshape((-1, 4)),
    "Slice": lambda P: P.M.Slice(),
    "SoftMax": lambda P: P.M.SoftMax(),
    "SpatialTf": lambda P: P.M.SpatialTf(shape=(4, 4)),
    "Split": lambda P: P.M.Split(axis=1, sections=(2, 2)),
    "SubtractMean": lambda P: P.M.SubtractMean(size=3),
    "Sum": lambda P: P.M.Sum(axis=1),
    "SwapAxes": lambda P: P.M.SwapAxes(1, 2),
    "Tile": lambda P: P.M.Tile(axis=1, times=2),
    "ToList": lambda P: P.M.ToList(),
    "Transpose": lambda P: P.M.Transpose(axes=(0, 2, 1)),
    "Upsample2D": lambda P: P.M.Upsample2D(scale=2),
    "Upsample3D": lambda P: P.M.Upsample3D(scale=2, mode="linear"),
}


def _rebuilt(P, spec):
    """The JSON blueprint rebuilt by ``P``'s factory: its JSON, or "refused"
    if the factory raised."""
    try:
        return _json(P.Blueprint.BlueprintFactory().build(spec))
    except Exception:   # the outcome compared across the packages
        return "refused"


def testEveryModuleClassIsListed():
    """``MODULES`` covers every module class the port's factory can build."""
    built = {name.split("-")[0] for name in MODULES}
    assert set(TBlueprint.BlueprintFactory().modules) - {"ConvND", "DeconvND", "BatchNormND", "Pool1D", "Pool2D",
                                                         "Pool3D", "Module"} <= built


@pytest.mark.parametrize("name", sorted(MODULES))
def testModuleBlueprintTwin(name):
    """The module's blueprint equals the JAX package's; rebuilt from the
    JSON by each package's factory, the two agree again (the init scheme
    "none" on rebuild), or both refuse."""
    J = _jax()
    np.random.seed(0)
    jmod = MODULES[name](J)
    np.random.seed(0)
    tmod = MODULES[name](PORT)

    assert _json(tmod) == _json(jmod)

    spec = json.loads(_json(jmod))
    jrebuilt, trebuilt = _rebuilt(J, spec), _rebuilt(PORT, spec)
    if spec["classname"] not in J.Blueprint.BlueprintFactory().modules and \
            spec["classname"] in TBlueprint.BlueprintFactory().modules:
        # the JAX package does not export the class (LRN): its factory cannot
        # build it, the port's can
        scheme = dict(spec["scheme"], **({"initscheme": "none"} if "initscheme" in spec["scheme"] else {}))
        jrebuilt = json.dumps(dict(spec, scheme=scheme), sort_keys=True)

    assert trebuilt == jrebuilt


# -- the narrow nets of the twins ------------------------------------------------------------------

ALEXNET = dict(maps=(8, 16, 24, 24, 16), fcs=(32, 32), classes=10, shape=(3, 67, 67))
C3D = dict(maps=(4, 8, 8, 16, 16), fcs=(16, 16), classes=10, shape=(3, 16, 32, 32))
SEGNET = ((2, 8), (2, 16), (3, 32))
SENTI = dict(vocabulary=100, branches=[3, 4, 5], sentlength=20, embsize=16)
IMDB = {"lstm": ("testlib.rnnimdbtrain", dict(numwords=50, maxlen=8)),
        "bilstm": ("testlib.birnnimdbtrain", dict(numwords=50, maxlen=8)),
        "cnn": ("testlib.cnnimdbtrain", dict(numwords=50, maxlen=12, embsize=10))}


def _imdb(kind):
    def build(P):
        module, widths = IMDB[kind]
        return importlib.import_module(module).buildNet(**widths) if P is not PORT else Seq.build(kind, **widths)
    return build


NETS = {
    "alexnet": lambda P: alexnetslice.buildNet(modules=P.M, containers=P.C, **ALEXNET),
    "c3d": lambda P: c3dslice.buildNet(modules=P.M, containers=P.C, **C3D),
    "segnet": lambda P: segslice.buildNet(SEGNET, modules=P.M, containers=P.C),
    "transformer": lambda P: importlib.import_module(P.Nets.__name__ + ".transformer").buildTransformerClassifier(
        50, 8, 16, nheads=4, nlayers=2, nclasses=2),
    "sentinet": lambda P: P.Nets.loadSentiNet(None, **SENTI),
    "lstm": _imdb("lstm"),
    "bilstm": _imdb("bilstm"),
    "cnn": _imdb("cnn"),
    "moe": lambda P: moeslice.buildNet(stages=2, dim=16, experts=2, modules=P.M, containers=P.C),
}


@pytest.mark.parametrize("kind", list(NETS))
def testNetBlueprintTwin(kind):
    """The net's blueprint equals the JAX package's key for key, and the
    port's factory rebuilds the JAX package's JSON into a net of the same
    blueprint (every init scheme "none"), as the JAX package's factory
    does."""
    J = _jax()
    np.random.seed(0)
    jnet = NETS[kind](J)
    np.random.seed(0)
    tnet = NETS[kind](PORT)

    assert _json(tnet) == _json(jnet)

    spec = json.loads(_json(jnet))
    assert _rebuilt(PORT, spec) == _rebuilt(J, spec)
    # a MaxUnpool2D's pool is not recorded: both factories refuse SegNet
    assert (_rebuilt(PORT, spec) == "refused") == (kind == "segnet")
