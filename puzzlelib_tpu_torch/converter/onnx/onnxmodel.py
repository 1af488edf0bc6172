"""Self-contained ONNX IR subset with wire-format serialization (a copy of
``puzzlelib_tpu/converter/onnx/onnxmodel.py``, which the port does not
import; the producer name is the port's, and ``Graph.serialize`` joins its
fields once, the same bytes without a copy of the graph per initializer).

Implements the slice of onnx.proto (field numbers per the public ONNX schema)
the exporter emits: ModelProto / GraphProto / NodeProto / AttributeProto /
TensorProto / ValueInfoProto.  Helper constructors mirror ``onnx.helper``.
"""

import numpy as np

from puzzlelib_tpu_torch.converter.onnx import protowire as pw


class TensorDataType:
    FLOAT = 1
    INT32 = 6
    INT64 = 7


FLOAT = TensorDataType.FLOAT


class AttrType:
    FLOAT = 1
    INT = 2
    STRING = 3
    TENSOR = 4
    FLOATS = 6
    INTS = 7
    STRINGS = 8


class Tensor:
    def __init__(self, name, dataType, dims, vals):
        self.name = name
        self.data_type = dataType
        self.dims = tuple(int(d) for d in dims)

        vals = np.asarray(vals)
        self.raw = vals.astype("<f4" if dataType == TensorDataType.FLOAT
                               else "<i4" if dataType == TensorDataType.INT32 else "<i8").tobytes()

    def serialize(self):
        out = b""
        for d in self.dims:
            out += pw.encodeInt(1, d)

        out += pw.encodeInt(2, self.data_type)
        out += pw.encodeBytes(8, self.name)
        out += pw.encodeBytes(9, self.raw)

        return out


class Attribute:
    def __init__(self, name, value):
        self.name = name
        self.value = value

    def serialize(self):
        out = pw.encodeBytes(1, self.name)
        v = self.value

        if isinstance(v, float):
            out += pw.encodeFloat(2, v) + pw.encodeInt(20, AttrType.FLOAT)

        elif isinstance(v, (bool, int, np.integer)):
            out += pw.encodeInt(3, int(v)) + pw.encodeInt(20, AttrType.INT)

        elif isinstance(v, (str, bytes)):
            out += pw.encodeBytes(4, v) + pw.encodeInt(20, AttrType.STRING)

        elif isinstance(v, Tensor):
            out += pw.encodeMessage(5, v.serialize()) + pw.encodeInt(20, AttrType.TENSOR)

        elif isinstance(v, (list, tuple, np.ndarray)):
            seq = list(v)

            if len(seq) > 0 and isinstance(seq[0], float):
                for f in seq:
                    out += pw.encodeField(7, pw.WIRE_FIXED32, float(f))
                out += pw.encodeInt(20, AttrType.FLOATS)
            else:
                for i in seq:
                    out += pw.encodeInt(8, int(i))
                out += pw.encodeInt(20, AttrType.INTS)

        else:
            raise TypeError("Unsupported attribute type %r" % type(v))

        return out


class Node:
    def __init__(self, opType, inputs, outputs, name=None, **attrs):
        self.op_type = opType
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.name = name
        self.attributes = [Attribute(k, v) for k, v in sorted(attrs.items())]

    def serialize(self):
        out = b""
        for inp in self.inputs:
            out += pw.encodeBytes(1, inp)

        for outp in self.outputs:
            out += pw.encodeBytes(2, outp)

        if self.name:
            out += pw.encodeBytes(3, self.name)

        out += pw.encodeBytes(4, self.op_type)

        for attr in self.attributes:
            out += pw.encodeMessage(5, attr.serialize())

        return out


class ValueInfo:
    def __init__(self, name, elemType, shape):
        self.name = name
        self.elem_type = elemType
        self.shape = tuple(shape)

    def serialize(self):
        dims = b""
        for d in self.shape:
            dims += pw.encodeMessage(1, pw.encodeInt(1, int(d)))  # Dimension.dim_value

        shapeProto = dims
        tensorType = pw.encodeInt(1, self.elem_type) + pw.encodeMessage(2, shapeProto)
        typeProto = pw.encodeMessage(1, tensorType)

        return pw.encodeBytes(1, self.name) + pw.encodeMessage(2, typeProto)


class Graph:
    def __init__(self, nodes, name, inputs, outputs, initializer=None):
        self.nodes = nodes
        self.name = name
        self.inputs = inputs
        self.outputs = outputs
        self.initializer = initializer or []

    def serialize(self):
        # the fields joined once: appending each to a growing buffer copies
        # the initializers already written once per initializer
        out = [pw.encodeMessage(1, node.serialize()) for node in self.nodes]
        out.append(pw.encodeBytes(2, self.name or "net"))

        out.extend(pw.encodeMessage(5, init.serialize()) for init in self.initializer)
        out.extend(pw.encodeMessage(11, inp.serialize()) for inp in self.inputs)
        out.extend(pw.encodeMessage(12, outp.serialize()) for outp in self.outputs)

        return b"".join(out)


class Model:
    IR_VERSION = 8
    OPSET = 13

    def __init__(self, graph, producerName="puzzlelib_tpu_torch"):
        self.graph = graph
        self.producer_name = producerName

    def serialize(self):
        opset = pw.encodeBytes(1, "") + pw.encodeInt(2, self.OPSET)

        out = pw.encodeInt(1, self.IR_VERSION)
        out += pw.encodeBytes(2, self.producer_name)
        out += pw.encodeMessage(7, self.graph.serialize())
        out += pw.encodeMessage(8, opset)

        return out

    def save(self, path):
        with open(path, "wb") as f:
            f.write(self.serialize())


# -- helpers mirroring onnx.helper -------------------------------------------

def makeNode(opType, inputs, outputs, name=None, **attrs):
    return Node(opType, inputs, outputs, name, **attrs)


def makeTensor(name, dataType, dims, vals):
    return Tensor(name, dataType, dims, vals)


def makeTensorValueInfo(name, elemType, shape):
    return ValueInfo(name, elemType, shape)


def makeGraph(nodes, name, inputs, outputs, initializer=None):
    return Graph(nodes, name, inputs, outputs, initializer)


def makeModel(graph, producerName="puzzlelib_tpu_torch"):
    return Model(graph, producerName)


# -- decoding (for round-trip tests and importers) ---------------------------

def parseModel(data):
    """Decode a serialized ModelProto into nested dicts (subset)."""
    fields = pw.fieldsToDict(data)

    model = {"ir_version": fields.get(1, [(0, 0)])[0][1]}
    if 2 in fields:
        model["producer_name"] = fields[2][0][1].decode()

    graphBuf = fields[7][0][1]
    model["graph"] = parseGraph(graphBuf)

    return model


def parseGraph(buf):
    fields = pw.fieldsToDict(buf)

    graph = {
        "name": fields.get(2, [(2, b"")])[0][1].decode(),
        "nodes": [parseNode(v) for _, v in fields.get(1, [])],
        "initializer": [parseTensor(v) for _, v in fields.get(5, [])],
        "inputs": [parseValueInfo(v) for _, v in fields.get(11, [])],
        "outputs": [parseValueInfo(v) for _, v in fields.get(12, [])],
    }

    return graph


def parseNode(buf):
    fields = pw.fieldsToDict(buf)

    return {
        "input": [v.decode() for _, v in fields.get(1, [])],
        "output": [v.decode() for _, v in fields.get(2, [])],
        "name": fields.get(3, [(2, b"")])[0][1].decode(),
        "op_type": fields[4][0][1].decode(),
        "attributes": {a["name"]: a for a in (parseAttribute(v) for _, v in fields.get(5, []))},
    }


def parseAttribute(buf):
    import struct

    fields = pw.fieldsToDict(buf)
    attr = {"name": fields[1][0][1].decode()}

    if 2 in fields:
        attr["f"] = struct.unpack("<f", fields[2][0][1])[0]
    if 3 in fields:
        attr["i"] = fields[3][0][1]
    if 4 in fields:
        attr["s"] = fields[4][0][1]
    if 5 in fields:
        attr["t"] = parseTensor(fields[5][0][1])
    if 7 in fields:
        attr["floats"] = [struct.unpack("<f", v)[0] for _, v in fields[7]]
    if 8 in fields:
        attr["ints"] = [v for _, v in fields[8]]

    return attr


def parseTensor(buf):
    fields = pw.fieldsToDict(buf)

    dataType = fields[2][0][1]
    dims = tuple(v for _, v in fields.get(1, []))

    dtype = {TensorDataType.FLOAT: "<f4", TensorDataType.INT32: "<i4", TensorDataType.INT64: "<i8"}[dataType]

    raw = fields.get(9, [(2, b"")])[0][1]
    vals = np.frombuffer(raw, dtype=dtype).reshape(dims) if raw else np.zeros(dims, dtype)

    return {
        "name": fields.get(8, [(2, b"")])[0][1].decode(),
        "data_type": dataType,
        "dims": dims,
        "vals": vals,
    }


def parseValueInfo(buf):
    fields = pw.fieldsToDict(buf)

    name = fields[1][0][1].decode()

    shape = ()
    if 2 in fields:
        typeFields = pw.fieldsToDict(fields[2][0][1])
        if 1 in typeFields:
            tensorFields = pw.fieldsToDict(typeFields[1][0][1])
            if 2 in tensorFields:
                shapeFields = pw.fieldsToDict(tensorFields[2][0][1])
                dims = []
                for _, dimBuf in shapeFields.get(1, []):
                    dimFields = pw.fieldsToDict(dimBuf)
                    dims.append(dimFields.get(1, [(0, 0)])[0][1])
                shape = tuple(dims)

    return {"name": name, "shape": shape}
