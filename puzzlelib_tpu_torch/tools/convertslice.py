"""Model files written from a net, as ``chip_smoke.py`` [convert] and the
tests carry nets through the converters.

The repo holds no published .caffemodel or .params file, so these writers
lay out a net's weights (read off its device through ``gpuarray.get``: a
bf16 net's as the f32 of its bf16 values, exactly) in the published files'
layouts, for the importers (``converter.caffe``, ``converter.mxnet``) to
read back:

- ``caffeV1FromNet``: the old (V1) NetParameter of Simonyan and Zisserman's
  ``VGG_ILSVRC_16_layers.caffemodel``: ``layers`` with enum types
  (CONVOLUTION = 4, INNER_PRODUCT = 14, RELU, POOLING, SOFTMAX), blobs
  sized by num / channels / height / width, a conv's weights (out, in, kh,
  kw), an inner product's (1, 1, out, in), every bias (1, 1, 1, N);
- ``caffeFromNet``: the new NetParameter of He et al.'s
  ``ResNet-50-model.caffemodel``: ``layer`` with string types, blobs sized
  by a BlobShape; ``Convolution`` (a bias only where the conv has one),
  ``BatchNorm`` with three blobs (mean and variance multiplied by the scale
  factor, then the factor), ``Scale`` with two (gamma, beta),
  ``InnerProduct`` (out, in) and (out, ), and the layers without blobs;
- ``mxnetFromNet``: an MXNet ``.params`` file as ``converter.mxnet`` reads
  it (header, the arrays with their shapes and type flags, the keys
  ``arg:<layer>_weight`` / ``_bias`` / ``_gamma`` / ``_beta`` and
  ``aux:<layer>_moving_mean`` / ``_moving_var``) and its ``-symbol.json``,
  with ``Convolution``, ``BatchNorm`` and ``FullyConnected`` nodes under the
  net's layer names and a fully connected weight as (out, in).

``leaves`` walks a Sequential / Parallel tree in forward order;
``onnxCounts`` gives the ONNX nodes by type and the count of initializers
that ``ONNXExporter`` emits for such a net, and ``onnxInitializers`` the
values it should write into them, in its order, read off the device anew.
"""

import json
import struct
from collections import Counter

import numpy as np

from puzzlelib_tpu_torch.backend import gpuarray
from puzzlelib_tpu_torch.converter.onnx import protowire as pw


V1_TYPES = {"CONVOLUTION": 4, "INNER_PRODUCT": 14, "POOLING": 17, "RELU": 18, "SOFTMAX": 20}


# -- Caffe ---------------------------------------------------------------------------------------------
#
# A message is built as a list of chunks (bytes, or byte views of the arrays)
# and joined once: nesting 553 MB of weights by concatenation would copy
# them once a level.

def _raw(array):
    """A byte view of ``array`` as C-ordered little-endian f32 (a copy only
    where it is not that already)."""
    return np.ascontiguousarray(array, dtype="<f4").reshape(-1).view(np.uint8)


def _field(fieldnum, chunks):
    """A length-delimited field around ``chunks``, as chunks."""
    return [pw.encodeTag(fieldnum, pw.WIRE_BYTES) + pw.encodeVarint(sum(len(chunk) for chunk in chunks))] + chunks


def caffeBlob(array, dims=None, legacy=False):
    """A BlobProto, as chunks: the values packed as f32, sized by ``dims``
    (default the array's shape) in a BlobShape, or with ``legacy`` by num /
    channels / height / width (``dims`` padded with ones in front to four)."""
    array = np.asarray(array, dtype=np.float32)
    dims = array.shape if dims is None else tuple(dims)

    if legacy:
        dims = (1, ) * (4 - len(dims)) + dims
        shape = b"".join(pw.encodeInt(field, d) for field, d in zip((1, 2, 3, 4), dims))
    else:
        shape = pw.encodeMessage(7, b"".join(pw.encodeInt(1, d) for d in dims))

    return [shape] + _field(5, [_raw(array)])


def caffeLayer(name, typ, blobs=()):
    """A LayerParameter (new format), as chunks: name, string type, blobs."""
    return [pw.encodeBytes(1, name), pw.encodeBytes(2, typ)] + [chunk for blob in blobs for chunk in _field(7, blob)]


def caffeV1Layer(name, typ, blobs=()):
    """A V1LayerParameter, as chunks: name, enum type, blobs."""
    return [pw.encodeBytes(4, name), pw.encodeInt(5, typ)] + [chunk for blob in blobs for chunk in _field(6, blob)]


def caffeNet(name, layers, v1=False):
    """The bytes of a NetParameter of ``layers`` (``layers`` field 2 in V1,
    ``layer`` 100 in the new format)."""
    fieldnum = 2 if v1 else 100
    return b"".join([pw.encodeBytes(1, name)] + [chunk for layer in layers for chunk in _field(fieldnum, layer)])


def leaves(net):
    """The leaf modules of a Sequential / Parallel tree in forward order."""
    from puzzlelib_tpu_torch.containers.container import Container

    if not isinstance(net, Container):
        return [net]

    return [leaf for child in net.graph for leaf in leaves(child)]


def _host(tensor):
    return np.asarray(gpuarray.get(tensor), dtype=np.float32)


def _linearOut(mod):
    """A Linear's weights as (out, in), the layout of Caffe and MXNet,
    transposed on its device (a host transpose of VGG-16's fc6 takes a
    second)."""
    if mod.transpose:
        raise ValueError("Linear %s holds its weights transposed" % mod.name)

    return _host(mod.W.t().contiguous())


def _unnamed(mod, index):
    return mod.name if mod.name is not None else "%s%d" % (type(mod).__name__.lower(), index)


def caffeV1FromNet(net):
    """The V1 caffemodel bytes of a net of convs, Linears, relus, pools and
    a SoftMax (VGG's)."""
    from puzzlelib_tpu_torch import modules as M

    layers = []
    for index, mod in enumerate(leaves(net)):
        name = _unnamed(mod, index)

        if isinstance(mod, M.Conv2D):
            blobs = [caffeBlob(_host(mod.W), legacy=True)]
            if mod.useBias:
                blobs.append(caffeBlob(_host(mod.b).ravel(), legacy=True))
            layers.append(caffeV1Layer(name, V1_TYPES["CONVOLUTION"], blobs))

        elif isinstance(mod, M.Linear):
            blobs = [caffeBlob(_linearOut(mod), legacy=True)]
            if mod.useBias:
                blobs.append(caffeBlob(_host(mod.b).ravel(), legacy=True))
            layers.append(caffeV1Layer(name, V1_TYPES["INNER_PRODUCT"], blobs))

        elif isinstance(mod, M.Activation):
            layers.append(caffeV1Layer(name, V1_TYPES["RELU"]))

        elif isinstance(mod, (M.MaxPool2D, M.AvgPool2D)):
            layers.append(caffeV1Layer(name, V1_TYPES["POOLING"]))

        elif isinstance(mod, M.SoftMax):
            layers.append(caffeV1Layer(name, V1_TYPES["SOFTMAX"]))

    return caffeNet(net.name, layers, v1=True)


# the new-format types of the layers without blobs, by module class
_NEW_TYPES = {"Activation": "ReLU", "MaxPool2D": "Pooling", "AvgPool2D": "Pooling", "Add": "Eltwise",
              "Flatten": "Flatten", "SoftMax": "Softmax"}


def caffeFromNet(net, scaleFactor=4.0):
    """The new-format caffemodel bytes of a net of convs, 2-d batch norms,
    Linears and layers without weights (ResNet's); each batch norm writes its
    running mean and variance multiplied by ``scaleFactor``, then the
    factor, and a Scale layer after it ("bn..." -> "scale...")."""
    from puzzlelib_tpu_torch import modules as M

    layers = []
    for index, mod in enumerate(leaves(net)):
        name = _unnamed(mod, index)

        if isinstance(mod, M.Conv2D):
            blobs = [caffeBlob(_host(mod.W))]
            if mod.useBias:
                blobs.append(caffeBlob(_host(mod.b).ravel()))
            layers.append(caffeLayer(name, "Convolution", blobs))

        elif isinstance(mod, M.BatchNorm2D):
            factor = np.float32(scaleFactor)
            stats = [caffeBlob(_host(mod.mean).ravel() * factor), caffeBlob(_host(mod.var).ravel() * factor),
                     caffeBlob(np.array([factor], dtype=np.float32))]
            layers.append(caffeLayer(name, "BatchNorm", stats))

            affine = [caffeBlob(_host(mod.scale).ravel()), caffeBlob(_host(mod.bias).ravel())]
            layers.append(caffeLayer(name.replace("bn", "scale", 1), "Scale", affine))

        elif isinstance(mod, M.Linear):
            blobs = [caffeBlob(_linearOut(mod))]
            if mod.useBias:
                blobs.append(caffeBlob(_host(mod.b).ravel()))
            layers.append(caffeLayer(name, "InnerProduct", blobs))

        else:
            typ = _NEW_TYPES.get(type(mod).__name__)
            if typ is not None:
                layers.append(caffeLayer(name, typ))

    return caffeNet(net.name, layers)


# -- MXNet ---------------------------------------------------------------------------------------------

MXNET_FLAGS = {np.dtype(np.float32): 0, np.dtype(np.float64): 1, np.dtype(np.float16): 2, np.dtype(np.uint8): 3,
               np.dtype(np.int32): 4}


def mxnetParams(keys, tensors):
    """The bytes of a ``.params`` file as ``converter.mxnet`` reads it."""
    parts = [struct.pack("<QQ", 0x112, 0), struct.pack("<Q", len(tensors))]

    for tensor in tensors:
        tensor = np.ascontiguousarray(tensor)
        parts += [struct.pack("<I", tensor.ndim), struct.pack("<%dI" % tensor.ndim, *tensor.shape),
                  struct.pack("<iii", 1, 0, MXNET_FLAGS[tensor.dtype]), tensor.reshape(-1).view(np.uint8)]

    parts.append(struct.pack("<Q", len(keys)))
    for key in keys:
        parts += [struct.pack("<Q", len(key)), key.encode()]

    return b"".join(parts)


def mxnetFromNet(net):
    """(``.params`` bytes, symbol dict) of a net of convs, 2-d batch norms,
    Linears and layers without weights."""
    from puzzlelib_tpu_torch import modules as M

    keys, tensors = [], []
    nodes = [{"op": "null", "name": "data", "inputs": []}]

    def param(kind, layer, suffix, value):
        keys.append("%s:%s_%s" % (kind, layer, suffix))
        tensors.append(np.ascontiguousarray(value, dtype=np.float32))

        nodes.append({"op": "null", "name": "%s_%s" % (layer, suffix), "inputs": []})
        return [len(nodes) - 1, 0, 0]

    last = [0, 0, 0]
    for index, mod in enumerate(leaves(net)):
        name = _unnamed(mod, index)
        inputs = [last]

        if isinstance(mod, M.Conv2D):
            op = "Convolution"
            inputs.append(param("arg", name, "weight", _host(mod.W)))
            if mod.useBias:
                inputs.append(param("arg", name, "bias", _host(mod.b).ravel()))

        elif isinstance(mod, M.BatchNorm2D):
            op = "BatchNorm"
            for kind, suffix, value in (("arg", "gamma", mod.scale), ("arg", "beta", mod.bias),
                                        ("aux", "moving_mean", mod.mean), ("aux", "moving_var", mod.var)):
                inputs.append(param(kind, name, suffix, _host(value).ravel()))

        elif isinstance(mod, M.Linear):
            op = "FullyConnected"
            inputs.append(param("arg", name, "weight", _linearOut(mod)))
            if mod.useBias:
                inputs.append(param("arg", name, "bias", _host(mod.b).ravel()))

        else:
            op = {"Activation": "Activation", "MaxPool2D": "Pooling", "AvgPool2D": "Pooling", "Flatten": "Flatten",
                  "SoftMax": "SoftmaxActivation"}.get(type(mod).__name__)
            if op is None:
                continue

        nodes.append({"op": op, "name": name, "inputs": inputs})
        last = [len(nodes) - 1, 0, 0]

    symbols = {"nodes": nodes, "arg_nodes": [i for i, node in enumerate(nodes) if node["op"] == "null"],
               "heads": [last]}
    return mxnetParams(keys, tensors), symbols


def writeMxnet(net, prefix):
    """Write ``<prefix>.params`` and ``<prefix>-symbol.json`` of ``net``;
    returns their paths."""
    params, symbols = mxnetFromNet(net)

    with open(prefix + ".params", "wb") as f:
        f.write(params)
    with open(prefix + "-symbol.json", "w") as f:
        json.dump(symbols, f)

    return prefix + ".params", prefix + "-symbol.json"


# -- ONNX ----------------------------------------------------------------------------------------------

_ONNX_OPS = {"MaxPool2D": "MaxPool", "AvgPool2D": "AveragePool", "Add": "Add", "Flatten": "Flatten",
             "SoftMax": "Softmax", "Concat": "Concat"}
_ONNX_ACTIVATIONS = {"relu": "Relu", "leakyRelu": "LeakyRelu", "sigmoid": "Sigmoid", "tanh": "Tanh"}


def onnxCounts(net):
    """(ONNX nodes by op type, initializer count) that ``ONNXExporter``
    emits for a Sequential / Parallel tree of the modules it handles."""
    from puzzlelib_tpu_torch import modules as M

    nodes, inits = Counter(), 0
    for mod in leaves(net):
        if isinstance(mod, M.Conv2D):
            nodes["Conv"] += 1
            inits += 2 if mod.useBias else 1
        elif isinstance(mod, (M.BatchNorm, M.BatchNorm2D)):
            nodes["BatchNormalization"] += 1
            inits += 4
        elif isinstance(mod, M.Linear):
            nodes.update(["MatMul", "Add"] if mod.useBias else ["MatMul"])
            inits += 2 if mod.useBias else 1
        elif isinstance(mod, M.Activation):
            nodes[_ONNX_ACTIVATIONS[mod.activation.value]] += 1
        elif type(mod).__name__ in _ONNX_OPS:
            nodes[_ONNX_OPS[type(mod).__name__]] += 1

    return dict(nodes), inits


def onnxInitializers(net):
    """The f32 values of the initializers ``ONNXExporter`` writes for a
    Sequential / Parallel tree, in its order: a conv's weights and bias, a
    batch norm's scale, bias, mean and variance, a Linear's weights and
    bias, each read through ``gpuarray.get``."""
    from puzzlelib_tpu_torch import modules as M

    values = []
    for mod in leaves(net):
        if isinstance(mod, (M.Conv2D, M.Linear)):
            values += [_host(mod.W)] + ([_host(mod.b).ravel()] if mod.useBias else [])
        elif isinstance(mod, (M.BatchNorm, M.BatchNorm2D)):
            values += [_host(tensor).ravel() for tensor in (mod.scale, mod.bias, mod.mean, mod.var)]

    return values
