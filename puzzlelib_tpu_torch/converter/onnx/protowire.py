"""Minimal protobuf wire-format encoder/decoder (a copy of
``puzzlelib_tpu/converter/onnx/protowire.py``, which the port does not import).

No ``onnx`` or ``protobuf`` runtime is needed: the ONNX exporter and the
Caffe importer write and read the wire format directly: varints,
length-delimited fields, and packed repeated scalars - everything the
ONNX/Caffe schema subset needs.
"""

import struct


WIRE_VARINT = 0
WIRE_FIXED64 = 1
WIRE_BYTES = 2
WIRE_FIXED32 = 5


def encodeVarint(value):
    out = bytearray()

    if value < 0:
        value &= (1 << 64) - 1

    while True:
        byte = value & 0x7F
        value >>= 7

        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def encodeTag(fieldnum, wiretype):
    return encodeVarint((fieldnum << 3) | wiretype)


def encodeField(fieldnum, wiretype, payload):
    if wiretype == WIRE_VARINT:
        return encodeTag(fieldnum, wiretype) + encodeVarint(payload)

    if wiretype == WIRE_BYTES:
        return encodeTag(fieldnum, wiretype) + encodeVarint(len(payload)) + payload

    if wiretype == WIRE_FIXED32:
        return encodeTag(fieldnum, wiretype) + struct.pack("<f", payload)

    if wiretype == WIRE_FIXED64:
        return encodeTag(fieldnum, wiretype) + struct.pack("<d", payload)

    raise ValueError(wiretype)


def encodeInt(fieldnum, value):
    return encodeField(fieldnum, WIRE_VARINT, int(value))


def encodeFloat(fieldnum, value):
    return encodeField(fieldnum, WIRE_FIXED32, float(value))


def encodeBytes(fieldnum, value):
    if isinstance(value, str):
        value = value.encode("utf-8")

    return encodeField(fieldnum, WIRE_BYTES, value)


def encodeMessage(fieldnum, messageBytes):
    return encodeField(fieldnum, WIRE_BYTES, messageBytes)


def encodePackedInts(fieldnum, values):
    payload = b"".join(encodeVarint(int(v)) for v in values)
    return encodeField(fieldnum, WIRE_BYTES, payload)


def encodePackedFloats(fieldnum, values):
    import numpy as np
    return encodeField(fieldnum, WIRE_BYTES, np.asarray(values, dtype="<f4").tobytes())


# -- decoding ----------------------------------------------------------------

def decodeVarint(buf, pos):
    result, shift = 0, 0

    while True:
        byte = buf[pos]
        pos += 1

        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos

        shift += 7


def iterFields(buf):
    """Yield (fieldnum, wiretype, value) triples; value is int for varint,
    bytes for length-delimited, raw 4/8 bytes for fixed."""
    pos = 0

    while pos < len(buf):
        tag, pos = decodeVarint(buf, pos)
        fieldnum, wiretype = tag >> 3, tag & 7

        if wiretype == WIRE_VARINT:
            value, pos = decodeVarint(buf, pos)
        elif wiretype == WIRE_BYTES:
            length, pos = decodeVarint(buf, pos)
            value = bytes(buf[pos:pos + length])
            pos += length
        elif wiretype == WIRE_FIXED32:
            value = bytes(buf[pos:pos + 4])
            pos += 4
        elif wiretype == WIRE_FIXED64:
            value = bytes(buf[pos:pos + 8])
            pos += 8
        else:
            raise ValueError("Unsupported wire type %d" % wiretype)

        yield fieldnum, wiretype, value


def fieldsToDict(buf):
    """Group decoded fields by field number (repeated fields become lists)."""
    out = {}

    for fieldnum, wiretype, value in iterFields(buf):
        out.setdefault(fieldnum, []).append((wiretype, value))

    return out
