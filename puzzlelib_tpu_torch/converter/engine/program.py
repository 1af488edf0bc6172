"""The engine's program for the native host driver (counterpart of the
reference's ``<name>.<dtype>.stablehlo.mlir``, which its PJRT driver reads).

``buildEngine`` writes, beside the ``torch.export`` file, the exported graph
as plain text that ``src/engine_driver.cpp`` reads without a JSON library
(``<name>.<dtype>.program``), and the tensors it reads as one raw blob
(``<name>.<dtype>.weights``).  The text, one record a line, fields split by
spaces:

    puzzlelib-engine-program 1
    device <cpu | cuda:0>
    weights <file name beside the program> <bytes>
    input <name> <dtype> <ndim> <sizes...>
    const <name> <dtype> <ndim> <sizes...> <strides...> <storage offset> <first byte> <bytes>
    node <name> <namespace::op> <overload | default> <positional count> <keyword count> <arguments...>
    getitem <name> <node> <index>
    output <node>

A constant's bytes are its storage from element 0 to the last element it
reaches, so the driver gives it back with the same strides and storage
offset: the layout decides which kernel a wrapper takes.  Nodes come in
graph order; positional arguments by the schema's position, keywords as
``<name>=<value>``; the driver fills the rest from the schema's defaults.
A value is one token:

    T:<node>            a tensor node         TL:<a>,~,<b>   a list of them (~ None)
    i:<int>  I:<ints>   ints (comma lists)    b:<0|1>  B:<bools>
    f:<hex>  F:<hexes>  floats as ``float.hex``, so the C++ ``strtod`` reads the same bits
    N                   None                  E:      an empty list, typed by the schema
    s:<ScalarType>  l:<Layout>  m:<MemoryFormat>  d:<Device>  S:<percent-encoded str>

Anything else (a symbolic size, a higher-order operator, a Python callable,
a mutated buffer) raises ``ProgramError`` at build time, naming the node.
"""

import operator
from urllib.parse import quote

import torch


MAGIC = "puzzlelib-engine-program 1"

# torch types by their c10 names, as the driver reads them
SCALAR_TYPES = {torch.float32: "Float", torch.float64: "Double", torch.float16: "Half",
                torch.bfloat16: "BFloat16", torch.int8: "Char", torch.uint8: "Byte", torch.int16: "Short",
                torch.int32: "Int", torch.int64: "Long", torch.bool: "Bool"}
LAYOUTS = {torch.strided: "Strided"}
MEMORY_FORMATS = {torch.contiguous_format: "Contiguous", torch.channels_last: "ChannelsLast",
                  torch.preserve_format: "Preserve", torch.channels_last_3d: "ChannelsLast3d"}


class ProgramError(ValueError):
    pass


class Ref:
    """A value of the program by name, for a program written by hand: what a
    ``torch.fx.Node`` is in an exported one."""

    def __init__(self, name):
        self.name = name


def _noSpace(text, what):
    if not text or any(c.isspace() for c in text):
        raise ProgramError("%s %r cannot be written as one token" % (what, text))
    return text


def _scalar(value, where):
    if isinstance(value, bool):
        return "b:%d" % value
    if isinstance(value, int):
        return "i:%d" % value
    if isinstance(value, float):
        return "f:%s" % value.hex()

    raise ProgramError("%s: unsupported argument %r of type %s" % (where, value, type(value).__name__))


def encode(value, where):
    """One argument as a token; ``where`` names the node for the error."""
    if isinstance(value, (torch.fx.Node, Ref)):
        return "T:" + _noSpace(value.name, "node name")

    if value is None:
        return "N"

    if isinstance(value, (list, tuple)):
        if not value:
            return "E:"

        if all(isinstance(v, (torch.fx.Node, Ref)) or v is None for v in value):
            return "TL:" + ",".join("~" if v is None else _noSpace(v.name, "node name") for v in value)

        if all(isinstance(v, bool) for v in value):
            return "B:" + ",".join("%d" % v for v in value)

        if all(isinstance(v, int) and not isinstance(v, bool) for v in value):
            return "I:" + ",".join("%d" % v for v in value)

        if all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in value):
            return "F:" + ",".join(float(v).hex() for v in value)

        raise ProgramError("%s: unsupported list argument %r" % (where, value))

    if isinstance(value, torch.dtype):
        if value not in SCALAR_TYPES:
            raise ProgramError("%s: unsupported dtype %s" % (where, value))
        return "s:" + SCALAR_TYPES[value]

    if isinstance(value, torch.layout):
        if value not in LAYOUTS:
            raise ProgramError("%s: unsupported layout %s" % (where, value))
        return "l:" + LAYOUTS[value]

    if isinstance(value, torch.memory_format):
        return "m:" + MEMORY_FORMATS[value]

    if isinstance(value, torch.device):
        return "d:" + str(value)

    if isinstance(value, str):
        return "S:" + quote(value, safe="")

    return _scalar(value, where)


def _extent(t):
    """Elements of ``t``'s storage from element 0 to the last it reaches."""
    if t.numel() == 0:
        return t.storage_offset()
    return t.storage_offset() + 1 + sum((size - 1) * stride for size, stride in zip(t.shape, t.stride()))


def constantBytes(t):
    """The raw bytes of ``t``'s storage that ``const`` records (from element
    0 to the last element it reaches), read on the host."""
    span = _extent(t)
    flat = t.detach().as_strided((span, ), (1, ), 0).cpu().contiguous()
    return flat.view(torch.uint8).numpy().tobytes() if span else b""


class Writer:
    """Collects a program's lines and its weight blob; ``save`` writes both.
    ``buildEngine`` fills it from an exported graph (``fromExported``); a
    test can write a program by hand with ``input``, ``const``, ``node``,
    ``getitem`` and ``output``."""

    def __init__(self, device):
        self.device = str(device)
        self.lines, self.blob = [], bytearray()

    def input(self, name, dtype, shape):
        self.lines.append("input %s %s %d %s" % (_noSpace(name, "input name"), SCALAR_TYPES[dtype], len(shape),
                                                 " ".join(str(int(s)) for s in shape)))

    def const(self, name, t):
        if t.dtype not in SCALAR_TYPES:
            raise ProgramError("constant %s: unsupported dtype %s" % (name, t.dtype))

        data = constantBytes(t)
        self.lines.append("const %s %s %d %s %s %d %d %d" % (
            _noSpace(name, "constant name"), SCALAR_TYPES[t.dtype], t.dim(), " ".join(str(s) for s in t.shape),
            " ".join(str(s) for s in t.stride()), t.storage_offset(), len(self.blob), len(data)))
        self.blob += data

    def node(self, name, op, overload, args=(), kwargs=None):
        kwargs = kwargs or {}
        where = "node %s (%s.%s)" % (name, op, overload or "default")
        tokens = [encode(a, where) for a in args]
        tokens += ["%s=%s" % (_noSpace(k, "keyword"), encode(v, where)) for k, v in kwargs.items()]
        self.lines.append("node %s %s %s %d %d%s" % (_noSpace(name, "node name"), _noSpace(op, "operator"),
                                                     overload or "default", len(args), len(kwargs),
                                                     "".join(" " + t for t in tokens)))

    def getitem(self, name, source, index):
        self.lines.append("getitem %s %s %d" % (_noSpace(name, "node name"), _noSpace(source, "node name"),
                                                int(index)))

    def output(self, name):
        self.lines.append("output %s" % _noSpace(name, "node name"))

    def save(self, programpath, weightspath):
        import os

        with open(weightspath, "wb") as f:
            f.write(self.blob)

        header = [MAGIC, "device %s" % self.device,
                  "weights %s %d" % (_noSpace(os.path.basename(weightspath), "weights file"), len(self.blob))]
        with open(programpath, "w") as f:
            f.write("\n".join(header + self.lines) + "\n")


def _constants(exported):
    """Placeholder name -> tensor of each lifted constant, parameter and
    buffer; the user inputs' placeholder names, in order."""
    from torch.export.graph_signature import InputKind

    tensors, inputs = {}, []
    for spec in exported.graph_signature.input_specs:
        if spec.kind == InputKind.USER_INPUT:
            inputs.append(spec.arg.name)
        elif spec.kind in (InputKind.CONSTANT_TENSOR, InputKind.PARAMETER, InputKind.BUFFER):
            table = exported.constants if spec.target in exported.constants else exported.state_dict
            tensors[spec.arg.name] = table[spec.target]
        else:
            raise ProgramError("input %s of kind %s has no place in an engine's program" % (spec.arg.name, spec.kind))

    return tensors, inputs


def fromExported(exported):
    """A ``Writer`` holding the exported program ``exported``: its device (the
    user input's), its user input, its constants, its nodes and its one
    output."""
    from torch.export.graph_signature import OutputKind

    if any(spec.kind != OutputKind.USER_OUTPUT for spec in exported.graph_signature.output_specs):
        raise ProgramError("the program mutates a buffer or an input: an engine's program only computes")

    tensors, inputs = _constants(exported)
    nodes = {node.name: node for node in exported.graph.nodes}
    if len(inputs) != 1:
        raise ProgramError("an engine's program takes one input, this one %d" % len(inputs))

    writer = Writer(nodes[inputs[0]].meta["val"].device)
    for node in exported.graph.nodes:
        if node.op == "placeholder":
            if node.name in tensors:
                writer.const(node.name, tensors[node.name])
            else:
                val = node.meta["val"]
                writer.input(node.name, val.dtype, tuple(val.shape))

        elif node.op == "call_function" and node.target is operator.getitem:
            source, index = node.args
            writer.getitem(node.name, source.name, index)

        elif node.op == "call_function" and isinstance(node.target, torch._ops.OpOverload):
            schema = node.target._schema
            known = {arg.name for arg in schema.arguments}
            unknown = [k for k in node.kwargs if k not in known]
            if unknown or len(node.args) > len(schema.arguments):
                raise ProgramError("node %s: arguments %s do not fit %s" % (node.name, unknown, schema))

            writer.node(node.name, schema.name, schema.overload_name, node.args, node.kwargs)

        elif node.op == "output":
            outs = node.args[0]
            if not isinstance(outs, (list, tuple)) or len(outs) != 1 or not isinstance(outs[0], torch.fx.Node):
                raise ProgramError("an engine's program has one tensor output, this one %r" % (outs, ))
            writer.output(outs[0].name)

        else:
            raise ProgramError("node %s: target %r (%s) has no place in an engine's program" %
                               (node.name, node.target, node.op))

    return writer
