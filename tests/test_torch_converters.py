"""The converters against the JAX package.

- The wire codec and the ONNX IR subset: the port's copies
  (``converter/onnx/{protowire,onnxmodel}.py``) give the JAX package's bytes
  for a fixed set of values, and each package's parsers read the other's
  output into the same fields.
- The ONNX exporter: a narrow net with every module type it handles
  (Conv2D with and without bias, both batch norms, the four activations,
  Identity, Dropout, both pools, Flatten, Linear with and without bias,
  SoftMax, Replicate + Parallel + Add, Split, Concat, MulAddConst, nearest
  Upsample2D and a Graph), a narrow VGG and a narrow residual net, built in
  both packages with the same weights and running stats: the serialized
  GraphProto bytes are equal.  A grouped conv and a module the exporter does
  not handle fail in both.
- The Caffe importer, new format (Convolution, Deconvolution, BatchNorm with
  its scale factor 0 and 4, Scale, InnerProduct, PReLU, with and without
  ``batchNormVarInverse``): from the same bytes the two HDF5 files hold the
  same datasets (name, shape, type and value); the port's net loads the JAX
  package's file and the JAX net the port's, and the forwards agree within
  1e-5 relative in f32.
- The old (V1) format's bias, (1, 1, 1, N) as old Caffe writes it: the JAX
  package fails on it ("name already exists"), the port imports it as the
  new-format import of the same weights (``converter/caffe/convertmodel.py``
  says why).
- The MXNet importer: the five type flags read alike, the same datasets from
  the same files (Convolution with and without bias, BatchNorm's four
  arrays, FullyConnected), and a bad magic raises ``ValueError`` in both.
- A narrow VGG-shaped net carried through a V1 caffemodel and a ``.params``
  file into ``chip_smoke.MemoryStore`` and loaded, and a narrow residual net
  through a new-format caffemodel (scale factor 4, ``assumeUniqueNames``):
  the outputs are the source net's bit for bit, as [convert] requires on
  the card.
- A process in which ``import h5py`` fails imports the three converter
  packages, imports into a store and exports ONNX; a path then raises an
  ``ImportError`` that names ``h5py``."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import containers as TC
from puzzlelib_tpu_torch import convert
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.converter import caffe as TCaffe
from puzzlelib_tpu_torch.converter import mxnet as TMx
from puzzlelib_tpu_torch.converter.onnx import ONNXExporter
from puzzlelib_tpu_torch.converter.onnx import onnxmodel as TOnnx
from puzzlelib_tpu_torch.converter.onnx import protowire as TPw
from puzzlelib_tpu_torch.models.nets import resnet as TResnet
from puzzlelib_tpu_torch.tools import convertslice as Files


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_BOUND = 1e-5


def _jax():
    """The JAX package's pieces; the twins skip where it does not import, as
    on the card's machine."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    from puzzlelib_tpu import containers, modules
    from puzzlelib_tpu.backend import gpuarray
    from puzzlelib_tpu.converter import caffe, mxnet
    from puzzlelib_tpu.converter.onnx import ONNXExporter as Exporter
    from puzzlelib_tpu.converter.onnx import onnxmodel, protowire
    from puzzlelib_tpu.models.nets import resnet

    return SimpleNamespace(M=modules, C=containers, Caffe=caffe, Mx=mxnet, Exporter=Exporter, Onnx=onnxmodel,
                           Pw=protowire, Resnet=resnet, upload=gpuarray.to_gpu, host=lambda t: np.asarray(t.get()))


def _port():
    return SimpleNamespace(M=T, C=TC, Caffe=TCaffe, Mx=TMx, Exporter=ONNXExporter, Onnx=TOnnx, Pw=TPw,
                           Resnet=TResnet, upload=lambda a: torch.from_numpy(np.ascontiguousarray(a)),
                           host=lambda t: t.detach().numpy())


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _sameTree(a, b):
    """Equal nested dicts / lists of values and arrays (arrays by type,
    shape and value)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for key in a:
            _sameTree(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _sameTree(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    else:
        assert a == b


def _datasets(path):
    """{name: array} of every dataset of an HDF5 file."""
    import h5py

    found = {}
    with h5py.File(path, "r") as hdf:
        hdf.visititems(lambda name, obj: found.__setitem__(name, obj[()]) if isinstance(obj, h5py.Dataset) else None)

    return found


def _sameDatasets(got, want):
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        value, other = np.asarray(value), np.asarray(got[name])
        assert other.dtype == value.dtype and other.shape == value.shape and np.array_equal(other, value), name


# -- the wire codec -------------------------------------------------------------------------------------------

WIRE_CASES = [
    ("encodeVarint", (0, )), ("encodeVarint", (1, )), ("encodeVarint", (300, )), ("encodeVarint", (2 ** 40 + 5, )),
    ("encodeVarint", (-1, )), ("encodeTag", (100, 2)), ("encodeField", (3, 0, 150)), ("encodeField", (4, 1, 2.5)),
    ("encodeField", (5, 2, b"abc")), ("encodeField", (6, 5, -1.25)), ("encodeInt", (1, 7)), ("encodeFloat", (2, 0.1)),
    ("encodeBytes", (3, "name")), ("encodeBytes", (3, b"\x00\xff")), ("encodeMessage", (7, b"\x08\x01")),
    ("encodePackedInts", (1, [1, 300, 2 ** 33])), ("encodePackedFloats", (5, [0.5, -2.0, 3.25])),
]


@pytest.mark.parametrize("name, args", WIRE_CASES, ids=["%s-%d" % (n, i) for i, (n, _) in enumerate(WIRE_CASES)])
def testProtowireEncodesAsJax(name, args):
    J = _jax()
    assert getattr(TPw, name)(*args) == getattr(J.Pw, name)(*args)


def testProtowireDecodesBothPackages():
    """A message of every field kind, encoded by each package, decodes into
    the same fields with either package's decoder."""
    J = _jax()
    fields = [case for case in WIRE_CASES if case[0] not in ("encodeVarint", "encodeTag")]
    messages = [b"".join(getattr(P.Pw, name)(*args) for name, args in fields) for P in (J, _port())]

    decoded = [P.Pw.fieldsToDict(buf) for P in (J, _port()) for buf in messages]
    for other in decoded[1:]:
        assert other == decoded[0]

    assert list(TPw.iterFields(messages[0])) == list(J.Pw.iterFields(messages[0]))
    assert TPw.decodeVarint(TPw.encodeVarint(2 ** 40 + 5), 0) == J.Pw.decodeVarint(J.Pw.encodeVarint(2 ** 40 + 5), 0)


# -- the ONNX IR subset ---------------------------------------------------------------------------------------

def _onnxPieces(O):
    tensors = [O.makeTensor("w", O.TensorDataType.FLOAT, (2, 3), np.arange(6, dtype=np.float32) / 7),
               O.makeTensor("i", O.TensorDataType.INT32, (3, ), [1, -2, 3]),
               O.makeTensor("l", O.TensorDataType.INT64, (2, ), [2 ** 40, -1])]
    nodes = [O.makeNode("Conv", ["x", "w"], ["y"], name="conv", pads=[1, 1, 1, 1], strides=[1, 1]),
             O.makeNode("LeakyRelu", ["y"], ["z"], alpha=0.2),
             O.makeNode("Resize", ["z"], ["r"], mode=b"nearest", flag=True, t=tensors[1], scales=[1.0, 2.0],
                        label="s", count=np.int64(3))]
    infos = [O.makeTensorValueInfo("x", O.FLOAT, (1, 3, 4, 4)), O.makeTensorValueInfo("r", O.FLOAT, (1, 2, 8, 8))]
    graph = O.makeGraph(nodes, "g", infos[:1], infos[1:], initializer=tensors)

    return {"tensor": tensors, "node": nodes, "valueinfo": infos, "graph": [graph],
            "model": [O.makeModel(graph, producerName="producer")]}


@pytest.mark.parametrize("kind", ["tensor", "node", "valueinfo", "graph", "model"])
def testOnnxModelSerializesAsJax(kind):
    J = _jax()
    got, want = _onnxPieces(TOnnx)[kind], _onnxPieces(J.Onnx)[kind]
    assert [piece.serialize() for piece in got] == [piece.serialize() for piece in want]


def testOnnxModelParsesBothPackages():
    """Each package's ``parseModel`` reads the other's model into the same
    tree; the port's default producer is its own name."""
    J = _jax()
    models = [_onnxPieces(P.Onnx)["model"][0].serialize() for P in (J, _port())]

    trees = [P.Onnx.parseModel(buf) for P in (J, _port()) for buf in models]
    for other in trees[1:]:
        _sameTree(other, trees[0])

    graph = _onnxPieces(TOnnx)["graph"][0]
    assert TOnnx.parseModel(TOnnx.makeModel(graph).serialize())["producer_name"] == "puzzlelib_tpu_torch"


# -- the ONNX exporter ----------------------------------------------------------------------------------------

def _allModules(P):
    """A narrow net with every module type the exporter handles, on (2, 3,
    16, 16); returns (net, its batch norms)."""
    M, C = P.M, P.C
    norms = [M.BatchNorm2D(8, name="bn1"), M.BatchNorm(16, name="bn_fc")]

    g1 = M.Conv2D(8, 8, 3, pad=1, name="gconv").node()
    g2 = M.Activation(M.tanh, name="gtanh").node(g1)
    g3 = M.Conv2D(8, 8, 1, name="gproj").node(g1)
    g4 = M.Add(name="gadd").node(g2, g3)

    net = C.Sequential(name="allnet")
    net.append(M.Conv2D(3, 8, 3, pad=1, name="conv1"))
    net.append(norms[0])
    net.append(M.Activation(M.relu, name="relu1"))
    net.append(M.Conv2D(8, 8, 3, stride=2, pad=1, useBias=False, name="conv2"))
    net.append(M.Activation(M.leakyRelu, args=(0.2, ), name="lrelu"))
    net.append(M.Activation(M.sigmoid, name="sigm"))
    net.append(M.Identity(name="ident"))
    net.append(M.Dropout(name="drop"))
    net.append(M.Replicate(2, name="rep"))
    net.append(C.Parallel(name="par").append(M.Conv2D(8, 8, 3, pad=1, name="pconv"))
               .append(M.MulAddConst(a=2.0, b=0.5, name="mac")))
    net.append(M.Add(name="add"))
    net.append(M.Split(axis=1, sections=[4, 4], name="split"))
    net.append(C.Parallel(name="par2").append(M.Activation(M.tanh, name="ptanh")).append(M.Identity(name="pid")))
    net.append(M.Concat(axis=1, name="cat"))
    net.append(C.Graph(inputs=g1, outputs=g4, name="block"))
    net.append(M.Upsample2D(2, mode="nearest", name="up"))
    net.append(M.MaxPool2D(2, 2, name="mpool"))
    net.append(M.AvgPool2D(2, 2, name="apool"))
    net.append(M.Flatten(name="flat"))
    net.append(M.Linear(8 * 4 * 4, 16, name="fc1"))
    net.append(norms[1])
    net.append(M.Linear(16, 10, useBias=False, name="fc2"))
    net.append(M.SoftMax(name="prob"))
    return net, norms


def _vgg(P, name="vggnarrow"):
    """A narrow VGG-shaped net on (2, 3, 16, 16): VGG's layer names."""
    M = P.M
    net = P.C.Sequential(name=name)
    for stage, (inmaps, maps) in enumerate([(3, 8), (8, 16)], start=1):
        net.append(M.Conv2D(inmaps, maps, 3, pad=1, name="conv%d_1" % stage))
        net.append(M.Activation(M.relu, name="relu%d_1" % stage))
        net.append(M.Conv2D(maps, maps, 3, pad=1, name="conv%d_2" % stage))
        net.append(M.Activation(M.relu, name="relu%d_2" % stage))
        net.append(M.MaxPool2D(2, 2, name="pool%d" % stage))

    net.append(M.Flatten())
    net.append(M.Linear(16 * 4 * 4, 32, name="fc6"))
    net.append(M.Activation(M.relu, name="relu6"))
    net.append(M.Linear(32, 32, name="fc7"))
    net.append(M.Activation(M.relu, name="relu7"))
    net.append(M.Linear(32, 10, name="fc8"))
    net.append(M.SoftMax())
    return net, []


def _residual(P, name="resnarrow"):
    """A narrow residual net of ``residBlock``s on (2, 3, 16, 16), ResNet's
    layer names; returns (net, its batch norms)."""
    M = P.M
    net = P.C.Sequential(name=name)
    net.append(M.Conv2D(3, 16, 3, pad=1, useBias=False, name="conv1"))
    net.append(M.BatchNorm2D(16, name="bn_conv1"))
    net.append(M.Activation(M.relu, name="conv1_relu"))
    net.append(M.MaxPool2D(3, 2, name="pool1"))
    net.extend(P.Resnet.residBlock(16, 4, 1, "2a", True, False, False, None))
    net.extend(P.Resnet.residBlock(16, 4, 1, "2b", False, False, False, None))
    net.append(M.AvgPool2D(3, 1))
    net.append(M.Flatten())
    net.append(M.Linear(16 * 5 * 5, 10, name="fc1000"))
    net.append(M.SoftMax())
    return net, [mod for mod in _leaves(net) if type(mod).__name__ == "BatchNorm2D"]


def _leaves(net):
    """The leaf modules of a Sequential / Parallel tree of either package."""
    children = getattr(net, "graph", None)
    return [net] if not isinstance(children, list) else [leaf for child in children for leaf in _leaves(child)]


def _twinNets(build, seed=0):
    """``build`` in both packages with the JAX net's weights in the port's,
    and the same random running stats in both batch norms."""
    J = _jax()
    np.random.seed(seed)
    jnet, jnorms = build(J)
    np.random.seed(seed + 1)
    tnet, tnorms = build(_port())

    convert.paramsFromNumpy(tnet, {name: J.host(var.data) for var, names in jnet.getVarTable().items()
                                   for name in names})

    rng = np.random.RandomState(seed + 2)
    for jnorm, tnorm in zip(jnorms, tnorms, strict=True):
        shape = tuple(tnorm.mean.shape)
        mean, var = rng.randn(*shape).astype(np.float32), (rng.rand(*shape) + 0.5).astype(np.float32)
        jnorm.setAttr("mean", J.upload(mean))
        jnorm.setAttr("var", J.upload(var))
        with torch.no_grad():
            tnorm.mean.copy_(torch.from_numpy(mean))
            tnorm.var.copy_(torch.from_numpy(var))

    return J, jnet, tnet


@pytest.mark.parametrize("build", [_allModules, _vgg, _residual], ids=["every-module", "vgg", "residual"])
def testOnnxExportGraphBytesAsJax(build, tmp_path):
    """The same net, weights and running stats give the same GraphProto
    bytes in both packages; the file parses back with the net's shapes."""
    J, jnet, tnet = _twinNets(build)
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "port")

    want = J.Exporter().export(jnet, (2, 3, 16, 16), str(tmp_path / "jax"))
    got = ONNXExporter().export(tnet, (2, 3, 16, 16), str(tmp_path / "port"))

    assert got.graph.serialize() == want.graph.serialize()

    parsed = TOnnx.parseModel((tmp_path / "port" / ("%s.onnx" % tnet.name)).read_bytes())
    assert parsed["producer_name"] == "puzzlelib_tpu_torch"
    assert parsed["graph"]["outputs"][0]["shape"] == tuple(tnet.dataShapeFrom((2, 3, 16, 16)))

    if build is not _allModules:
        counts, inits = Files.onnxCounts(tnet)
        ops = {}
        for node in parsed["graph"]["nodes"]:
            ops[node["op_type"]] = ops.get(node["op_type"], 0) + 1
        assert ops == counts and len(parsed["graph"]["initializer"]) == inits


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("kind", ["grouped-conv", "tile"])
def testOnnxExportRefusesAsJax(package, kind, tmp_path):
    """A grouped conv fails the exporter's assert, a module it does not
    handle raises ``NotImplementedError``, in both packages."""
    P = _jax() if package == "jax" else _port()
    net = P.C.Sequential(name="refused")
    net.append(P.M.Conv2D(4, 4, 3, pad=1, groups=2, name="gconv") if kind == "grouped-conv" else
               P.M.Tile(axis=1, times=2, name="tile"))

    with pytest.raises(AssertionError if kind == "grouped-conv" else NotImplementedError):
        P.Exporter().export(net, (1, 4, 6, 6), str(tmp_path))


# -- the Caffe importer ---------------------------------------------------------------------------------------

CAFFE_CASES = [(0.0, False), (4.0, False), (4.0, True), (0.0, True)]


def _caffeNewFormat(scaleFactor, seed=3):
    """A new-format caffemodel of every layer type the importer reads, for
    the net of ``_caffeTwinNet``."""
    rng = np.random.RandomState(seed)
    f32 = lambda *shape: rng.randn(*shape).astype(np.float32)  # noqa: E731
    factor = np.float32(scaleFactor)
    blob = Files.caffeBlob

    layers = [
        Files.caffeLayer("conv1", "Convolution", [blob(f32(4, 3, 3, 3)), blob(f32(4))]),
        Files.caffeLayer("prelu1", "PReLU", [blob(rng.rand(4).astype(np.float32))]),
        Files.caffeLayer("deconv1", "Deconvolution", [blob(f32(4, 4, 2, 2)), blob(f32(4))]),
        Files.caffeLayer("bn1", "BatchNorm", [blob(f32(4) * factor),
                                              blob((rng.rand(4) + 0.5).astype(np.float32) * factor),
                                              blob(np.array([factor]))]),
        Files.caffeLayer("scale1", "Scale", [blob(f32(4)), blob(f32(4))]),
        Files.caffeLayer("relu1", "ReLU"),
        Files.caffeLayer("fc", "InnerProduct", [blob(f32(5, 4 * 16 * 16)), blob(f32(5))]),
    ]
    return Files.caffeNet("testnet", layers)


def _caffeTwinNet(P):
    """The net the caffemodel of ``_caffeNewFormat`` holds, on (2, 3, 8, 8)."""
    M = P.M
    net = P.C.Sequential(name="testnet")
    net.append(M.Conv2D(3, 4, 3, pad=1, name="conv1"))
    net.append(M.PRelu(4, name="prelu1"))
    net.append(M.Deconv2D(4, 4, 2, stride=2, name="deconv1"))
    net.append(M.BatchNorm2D(4, name="bn1"))
    net.append(M.Activation(M.relu, name="relu1"))
    net.append(M.Flatten(name="flat"))
    net.append(M.Linear(4 * 16 * 16, 5, name="fc"))
    return net


def _importBoth(J, tmp_path, data, **kwargs):
    """(the port's HDF5 path, the JAX package's) of the caffemodel ``data``."""
    model = tmp_path / "model.caffemodel"
    model.write_bytes(data)

    paths = (str(tmp_path / "port.hdf"), str(tmp_path / "jax.hdf"))
    TCaffe.convert(str(model), paths[0], **kwargs)
    J.Caffe.convert(str(model), paths[1], **kwargs)
    return paths


def _varInverse(varInverse):
    return dict(batchNormVarInverse=True, eps=1e-5) if varInverse else {}


@pytest.mark.parametrize("scaleFactor, varInverse", CAFFE_CASES)
def testCaffeNewFormatDatasetsAsJax(scaleFactor, varInverse, tmp_path):
    J = _jax()
    port, jax = _importBoth(J, tmp_path, _caffeNewFormat(scaleFactor), **_varInverse(varInverse))

    want = _datasets(jax)
    _sameDatasets(_datasets(port), want)

    assert "links/testnet.bn1.scale" in want and "attrs/testnet.bn1.var" in want
    assert TCaffe.loadNetParameter(str(tmp_path / "model.caffemodel"))["name"] == "testnet"


@pytest.mark.parametrize("scaleFactor, varInverse", CAFFE_CASES)
def testCaffeFilesLoadAcrossPackages(scaleFactor, varInverse, tmp_path):
    """The port's net loads the JAX importer's file, the JAX net the port's;
    the eval forwards agree within 1e-5 relative in f32."""
    J = _jax()
    port, jax = _importBoth(J, tmp_path, _caffeNewFormat(scaleFactor), **_varInverse(varInverse))

    np.random.seed(7)
    jnet = _caffeTwinNet(J)
    np.random.seed(8)
    tnet = _caffeTwinNet(_port())

    tnet.load(jax)
    jnet.load(port)
    jnet.evalMode()
    tnet.evalMode()

    x = np.random.RandomState(9).randn(2, 3, 8, 8).astype(np.float32)
    want = J.host(jnet(J.upload(x)))
    got = tnet(torch.from_numpy(x)).numpy()

    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= F32_BOUND * max(1.0, np.abs(want).max())


def _v1Files(seed=4):
    """(V1 caffemodel, new-format caffemodel) of the same conv and inner
    product weights; the V1 biases are (1, 1, 1, N), as old Caffe writes them."""
    rng = np.random.RandomState(seed)
    W, b = rng.randn(4, 3, 3, 3).astype(np.float32), rng.randn(4).astype(np.float32)
    Wfc, bfc = rng.randn(5, 4 * 8 * 8).astype(np.float32), rng.randn(5).astype(np.float32)
    blob, v1 = Files.caffeBlob, Files.V1_TYPES

    old = Files.caffeNet("v1net", [
        Files.caffeV1Layer("conv1", v1["CONVOLUTION"], [blob(W, legacy=True), blob(b, legacy=True)]),
        Files.caffeV1Layer("relu1", v1["RELU"]),
        Files.caffeV1Layer("fc", v1["INNER_PRODUCT"], [blob(Wfc, legacy=True), blob(bfc, legacy=True)]),
    ], v1=True)
    new = Files.caffeNet("v1net", [
        Files.caffeLayer("conv1", "Convolution", [blob(W), blob(b)]), Files.caffeLayer("relu1", "ReLU"),
        Files.caffeLayer("fc", "InnerProduct", [blob(Wfc), blob(bfc)]),
    ])
    return old, new


def testJaxV1BiasBlobFailsInTheReference(tmp_path):
    """The JAX package takes a V1 bias of (1, 1, 1, N) for a second weight
    and fails writing it (ROADMAP Queue 3)."""
    J = _jax()
    path = tmp_path / "v1.caffemodel"
    path.write_bytes(_v1Files()[0])

    js = J.Caffe.loadNetParameter(str(path))
    assert [blob["shape"]["dim"] for blob in js["layers"][0]["blobs"]] == [[4, 3, 3, 3], [1, 1, 1, 4]]

    with pytest.raises(ValueError, match="name already exists"):
        J.Caffe.js2hdf(js, str(tmp_path / "jax.hdf"))


def testPortImportsV1BiasAsNewFormat(tmp_path):
    """The port takes a V1 layer's blobs by their place: the same bytes land
    in the same datasets as the new-format import of those weights, by
    either package, in a file and in a store."""
    import chip_smoke

    J = _jax()
    old, new = _v1Files()
    (tmp_path / "v1.caffemodel").write_bytes(old)
    (tmp_path / "new.caffemodel").write_bytes(new)

    TCaffe.convert(str(tmp_path / "v1.caffemodel"), str(tmp_path / "port-v1.hdf"))
    J.Caffe.convert(str(tmp_path / "new.caffemodel"), str(tmp_path / "jax-new.hdf"))

    want = _datasets(str(tmp_path / "jax-new.hdf"))
    _sameDatasets(_datasets(str(tmp_path / "port-v1.hdf")), want)
    assert want["params/1"].shape == (1, 4, 1, 1) and want["params/3"].shape == (5, )

    store = chip_smoke.MemoryStore()
    TCaffe.js2hdf(TCaffe.loadNetParameter(str(tmp_path / "v1.caffemodel")), store)
    for name, value in want.items():
        group, key = name.split("/")
        got = np.asarray(store[group][key][()])
        assert got.dtype == value.dtype and np.array_equal(got, value), name


# -- the MXNet importer ---------------------------------------------------------------------------------------

def _mxnetFile(seed=5):
    """(``.params`` bytes, symbols): two convs (one without bias), a batch
    norm's four arrays and a fully connected layer."""
    rng = np.random.RandomState(seed)
    f32 = lambda *shape: rng.randn(*shape).astype(np.float32)  # noqa: E731
    table = {"arg:conv0_weight": f32(4, 3, 3, 3), "arg:conv0_bias": f32(4), "arg:conv1_weight": f32(4, 4, 1, 1),
             "arg:bn0_gamma": f32(4), "arg:bn0_beta": f32(4), "aux:bn0_moving_mean": f32(4),
             "aux:bn0_moving_var": (rng.rand(4) + 0.5).astype(np.float32), "arg:fc0_weight": f32(5, 64),
             "arg:fc0_bias": f32(5)}
    nodes = [{"op": "null", "name": "data", "inputs": []}] + \
        [{"op": op, "name": name, "inputs": []} for op, name in
         (("Convolution", "conv0"), ("Convolution", "conv1"), ("BatchNorm", "bn0"), ("Activation", "relu0"),
          ("FullyConnected", "fc0"))]

    return Files.mxnetParams(list(table), list(table.values())), {"nodes": nodes}


def testMxnetReadsFiveTypeFlagsAsJax(tmp_path):
    """Arrays of the five type flags read back with their types and values,
    alike in both packages, and their keys after them."""
    J = _jax()
    tensors = [np.arange(6, dtype=np.float32).reshape(2, 3) / 3, np.linspace(0, 1, 4),
               np.arange(5, dtype=np.float16) / 4, np.arange(7, dtype=np.uint8) * 30,
               np.arange(-3, 3, dtype=np.int32).reshape(3, 2)]
    keys = ["arg:f32", "arg:f64", "arg:f16", "aux:u8", "aux:i32"]
    path = tmp_path / "types.params"
    path.write_bytes(Files.mxnetParams(keys, tensors))

    read = {}
    for name, P in (("jax", J), ("port", _port())):
        with open(path, "rb") as f:
            P.Mx.readHeader(f)
            read[name] = (P.Mx.readData(f), P.Mx.readKeys(f))

    _sameTree(read["port"], read["jax"])
    _sameTree(read["port"], (tensors, keys))


def testMxnetDatasetsAsJax(tmp_path):
    J = _jax()
    params, symbols = _mxnetFile()
    (tmp_path / "model.params").write_bytes(params)
    (tmp_path / "model-symbol.json").write_text(json.dumps(symbols))

    args = (str(tmp_path / "model.params"), str(tmp_path / "model-symbol.json"))
    port = TMx.convert(*args, hdfpath=str(tmp_path / "port.hdf"))
    jax = J.Mx.convert(*args, hdfpath=str(tmp_path / "jax.hdf"))

    want = _datasets(jax)
    _sameDatasets(_datasets(port), want)
    assert "links/model.conv1.W" in want and "links/model.conv1.b" not in want
    assert want["attrs/model.bn0.var"].shape == (1, 4, 1, 1)


@pytest.mark.parametrize("package", ["jax", "port"])
def testMxnetBadMagicRaises(package, tmp_path):
    P = _jax() if package == "jax" else _port()
    path = tmp_path / "bad.params"
    path.write_bytes(b"\x13\x01" + bytes(14) + Files.mxnetParams([], [])[16:])

    with open(path, "rb") as f, pytest.raises(ValueError, match="magic"):
        P.Mx.readHeader(f)


# -- nets carried through files into a store ------------------------------------------------------------------

def _carry(kind, net, tmp_path):
    """``net``'s weights written as ``kind`` into ``tmp_path``, imported into
    a ``chip_smoke.MemoryStore``."""
    import chip_smoke

    store = chip_smoke.MemoryStore()
    if kind == "caffe-v1":
        (tmp_path / "m.caffemodel").write_bytes(Files.caffeV1FromNet(net))
        TCaffe.js2hdf(TCaffe.loadNetParameter(str(tmp_path / "m.caffemodel")), store)

    elif kind == "caffe":
        (tmp_path / "m.caffemodel").write_bytes(Files.caffeFromNet(net, scaleFactor=4.0))
        TCaffe.js2hdf(TCaffe.loadNetParameter(str(tmp_path / "m.caffemodel")), store)

    else:
        paramsPath, symbolPath = Files.writeMxnet(net, str(tmp_path / net.name))
        with open(paramsPath, "rb") as f:
            TMx.readHeader(f)
            tensors, keys = TMx.readData(f), TMx.readKeys(f)
        TMx.buildHdf(keys, tensors, TMx.convertmodel.loadSymbols(symbolPath), store, net.name)

    return store


@pytest.mark.parametrize("kind, build", [("caffe-v1", _vgg), ("mxnet", _vgg), ("caffe", _residual),
                                         ("mxnet", _residual)], ids=["vgg-caffe-v1", "vgg-mxnet", "residual-caffe",
                                                                     "residual-mxnet"])
def testNetCarriedThroughFileBitEqual(kind, build, tmp_path):
    """A net written as a model file, imported into a store and loaded into
    a net of the same architecture built from another seed serves the
    source net's output bit for bit; every variable and running stat too."""
    np.random.seed(10)
    source, norms = build(_port())
    rng = np.random.RandomState(11)
    with torch.no_grad():
        for norm in norms:
            norm.mean.copy_(torch.from_numpy(rng.randn(*norm.mean.shape).astype(np.float32)))
            norm.var.copy_(torch.from_numpy((rng.rand(*norm.var.shape) + 0.5).astype(np.float32)))

    store = _carry(kind, source, tmp_path)

    np.random.seed(12)
    loaded, _ = build(_port())
    loaded.load(store, assumeUniqueNames=build is _residual)

    for net in (source, loaded):
        net.evalMode()

    x = torch.from_numpy(np.random.RandomState(13).randn(2, 3, 16, 16).astype(np.float32))
    want = source(x).clone()
    assert torch.equal(loaded(x), want)

    for (name, got), (_, ref) in zip(sorted(convert.attrsToNumpy(loaded).items()),
                                     sorted(convert.attrsToNumpy(source).items())):
        assert np.array_equal(got, ref), name


NO_H5PY = """
import os, sys
sys.modules["h5py"] = None
import numpy as np
import torch
from puzzlelib_tpu_torch import config
config.device = "cpu"
from puzzlelib_tpu_torch.converter import caffe, mxnet, onnx
from puzzlelib_tpu_torch.converter.onnx import onnxmodel
from puzzlelib_tpu_torch.containers import Sequential
from puzzlelib_tpu_torch.modules import Conv2D, Activation, relu, Flatten, Linear
from puzzlelib_tpu_torch.tools import convertslice as Files
import chip_smoke

np.random.seed(0)
net = Sequential(name="tiny")
net.append(Conv2D(3, 4, 3, pad=1, name="conv1")).append(Activation(relu, name="relu1"))
net.append(Flatten()).append(Linear(4 * 6 * 6, 3, name="fc"))
net.evalMode()
x = torch.from_numpy(np.random.RandomState(1).randn(2, 3, 6, 6).astype(np.float32))
want = net(x).clone()
workdir = sys.argv[1]

with open(os.path.join(workdir, "tiny.caffemodel"), "wb") as f:
    f.write(Files.caffeV1FromNet(net))
store = chip_smoke.MemoryStore()
caffe.js2hdf(caffe.loadNetParameter(os.path.join(workdir, "tiny.caffemodel")), store)
net.load(store)
assert torch.equal(net(x), want)

paramsPath, symbolPath = Files.writeMxnet(net, os.path.join(workdir, "tiny"))
with open(paramsPath, "rb") as f:
    mxnet.readHeader(f)
    tensors, keys = mxnet.readData(f), mxnet.readKeys(f)
mxstore = chip_smoke.MemoryStore()
mxnet.buildHdf(keys, tensors, mxnet.convertmodel.loadSymbols(symbolPath), mxstore, "tiny")
net.load(mxstore)
assert torch.equal(net(x), want)

onnx.ONNXExporter().export(net, (2, 3, 6, 6), workdir)
assert len(onnxmodel.parseModel(open(os.path.join(workdir, "tiny.onnx"), "rb").read())["graph"]["nodes"]) == 5

try:
    caffe.js2hdf(caffe.loadNetParameter(os.path.join(workdir, "tiny.caffemodel")), os.path.join(workdir, "t.hdf"))
except ImportError as e:
    print("REFUSED", "h5py" in str(e))

print("LOADED", sorted(m for m in sys.modules if sys.modules[m] is not None and
                       m.split(".")[0] in ("h5py", "jax", "ml_dtypes", "puzzlelib_tpu", "graphviz")))
"""


def testConvertersWithoutH5py(tmp_path):
    proc = subprocess.run([sys.executable, "-c", NO_H5PY, str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))

    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "REFUSED True" in proc.stdout and "LOADED []" in proc.stdout, proc.stdout
