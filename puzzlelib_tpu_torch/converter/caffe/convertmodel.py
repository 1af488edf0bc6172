"""Caffe .caffemodel -> PuzzleLib HDF5 weight importer (counterpart of
``puzzlelib_tpu/converter/caffe/convertmodel.py``).

The NetParameter subset is decoded straight from the wire format (field
numbers from the public caffe.proto), so no protobuf runtime or codegen
step is needed.  The store written is the JAX package's layout, dataset for
dataset: ``links/<net>.<layer>.<param>`` -> index, ``params/<index>``, and
a batch norm's running stats under ``attrs``; so ``loadVGG(store, "16")``
and ``loadResNet(store, "50")`` read it as they read a checkpoint.

``js2hdf`` takes a path (opened with ``h5py``, imported only then) or an
open store: any object answering ``create_group``, ``require_group`` and
``create_dataset`` as an ``h5py`` group does.

One divergence from the JAX package, in the old (V1) format: a layer's
blobs are taken by their place, as Caffe's V1 layers define them, blob 0 the
weights and blob 1 the bias.  The JAX package goes by the count of
non-zero dims, and old Caffe writes a bias as (1, 1, 1, N): it takes that
bias for a second weight and fails (an ``h5py`` store refuses the second
``<layer>.W``).  Here the bias lands as ``<layer>.b``, shaped as the new
format shapes it.
"""

import numpy as np

from puzzlelib_tpu_torch import hdf as hdfcodec
from puzzlelib_tpu_torch.converter.onnx import protowire as pw


# caffe.proto field numbers (subset)
# NetParameter: name=1, layers(V1)=2, layer(new)=100
# LayerParameter: name=1, type=2 (string), blobs=7
# V1LayerParameter: layer(V0)=1, bottom=2, top=3, name=4, type=5 (enum), blobs=6
# BlobProto: num=1, channels=2, height=3, width=4, data=5 (repeated float), shape=7
# BlobShape: dim=1 (repeated int64)


def _decodeFloats(entries):
    """The floats of a repeated float field, packed or not, as one f32 array."""
    chunks = []

    for wiretype, value in entries:
        if wiretype not in (pw.WIRE_FIXED32, pw.WIRE_BYTES):  # one value, or packed
            raise ValueError("Bad float wire type %s" % wiretype)

        chunks.append(np.frombuffer(value, dtype="<f4"))

    if not chunks:
        return np.zeros(0, dtype=np.float32)

    return np.concatenate(chunks).astype(np.float32, copy=False)


def _decodeInts(entries):
    vals = []

    for wiretype, value in entries:
        if wiretype == pw.WIRE_VARINT:
            vals.append(value)
        elif wiretype == pw.WIRE_BYTES:  # packed
            pos = 0
            while pos < len(value):
                v, pos = pw.decodeVarint(value, pos)
                vals.append(v)

    return vals


def _parseBlob(buf):
    fields = pw.fieldsToDict(buf)

    blob = {"data": _decodeFloats(fields.get(5, []))}

    if 7 in fields:
        shapeFields = pw.fieldsToDict(fields[7][0][1])
        blob["shape"] = {"dim": _decodeInts(shapeFields.get(1, []))}
    else:
        dims = [fields.get(i, [(0, 0)])[0][1] for i in (1, 2, 3, 4)]
        blob["shape"] = {"dim": [d for d in dims]}

    return blob


def _parseNewLayer(buf):
    fields = pw.fieldsToDict(buf)

    return {
        "name": fields.get(1, [(2, b"")])[0][1].decode(),
        "type": fields.get(2, [(2, b"")])[0][1].decode(),
        "blobs": [_parseBlob(v) for _, v in fields.get(7, [])],
    }


def _parseV1Layer(buf):
    fields = pw.fieldsToDict(buf)

    return {
        "name": fields.get(4, [(2, b"")])[0][1].decode(),
        "type": fields.get(5, [(0, 0)])[0][1],
        "blobs": [_parseBlob(v) for _, v in fields.get(6, [])],
    }


def loadNetParameter(caffemodel):
    """Decode a .caffemodel into the reference's json-ish dict shape."""
    with open(caffemodel, "rb") as f:
        buf = f.read()

    fields = pw.fieldsToDict(buf)

    js = {}
    if 1 in fields:
        js["name"] = fields[1][0][1].decode()

    if 100 in fields:
        js["layer"] = [_parseNewLayer(v) for _, v in fields[100]]
    elif 2 in fields:
        js["layers"] = [_parseV1Layer(v) for _, v in fields[2]]

    return js


def js2hdf(js, hdf, compress="gzip", netName=None, **kwargs):
    """Write the decoded net ``js`` into ``hdf``, a path or an open store."""
    hdf, owned = hdfcodec.openStore(hdf, "w")

    try:
        if "layer" in js:
            parseNewCaffeFormat(js, hdf, compress, netName, **kwargs)
        else:
            parseOldCaffeFormat(js, hdf, compress, netName)

    finally:
        if owned:
            hdf.close()


def parseOldCaffeFormat(js, hdf, compress="gzip", netName=None):
    paramlayers = {4: "convolution", 39: "deconvolution", 14: "inner_product"}

    linkGrp = hdf.create_group("links")
    paramGrp = hdf.create_group("params")
    hdf.require_group("attrs")

    if netName is None:
        netName = js.get("name", "net")

    paramIdx = 0
    for layer in js["layers"]:
        if "layer" in layer:
            layer = layer["layer"]

        if layer["type"] not in paramlayers:
            continue

        layertype = paramlayers[layer["type"]]
        layerName = "%s.%s" % (netName, layer["name"])

        if len(layer["blobs"]) > 2:
            raise ValueError("V1 layer %s has %d blobs (Caffe's take the weights and a bias)" %
                             (layer["name"], len(layer["blobs"])))

        for place, blob in enumerate(layer["blobs"]):
            param = blob["data"]

            if place == 1:
                if layertype == "inner_product":
                    b = param.reshape(param.shape[0])
                else:
                    b = param.reshape(1, param.shape[0], 1, 1)

                linkGrp.create_dataset("%s.b" % layerName, data=paramIdx)
                paramGrp.create_dataset(str(paramIdx), data=b, compression=compress)
            else:
                dim = [d for d in blob["shape"]["dim"] if d > 0] or [param.shape[0]]

                W = param.reshape(dim)
                if layertype == "inner_product":
                    W = W.reshape(W.shape[-2], W.shape[-1]).T

                linkGrp.create_dataset("%s.W" % layerName, data=paramIdx)
                paramGrp.create_dataset(str(paramIdx), data=W, compression=compress)

            paramIdx += 1


def parseNewCaffeFormat(js, hdf, compress="gzip", netName=None, **kwargs):
    paramlayers = {"Convolution", "Deconvolution", "InnerProduct", "BatchNorm", "Scale", "PReLU"}

    linkGrp = hdf.create_group("links")
    paramGrp = hdf.create_group("params")
    attrGrp = hdf.require_group("attrs")

    layers = js["layer"]
    if netName is None:
        netName = js.get("name", "net")

    paramIdx = 0
    for i, layer in enumerate(layers):
        if layer["type"] not in paramlayers:
            continue

        layertype = layer["type"]
        layerName = "%s.%s" % (netName, layer["name"])
        blobs = layer["blobs"]

        if layertype in ("Convolution", "Deconvolution"):
            for blob in blobs:
                param = blob["data"]
                dim = blob["shape"]["dim"]

                if len(dim) == 1:
                    b = param.reshape(1, param.shape[0], 1, 1)
                    linkGrp.create_dataset("%s.b" % layerName, data=paramIdx)
                    paramGrp.create_dataset(str(paramIdx), data=b, compression=compress)
                else:
                    W = param.reshape(dim)
                    linkGrp.create_dataset("%s.W" % layerName, data=paramIdx)
                    paramGrp.create_dataset(str(paramIdx), data=W, compression=compress)

                paramIdx += 1

        elif layertype == "InnerProduct":
            for blob in blobs:
                param = blob["data"]
                dim = blob["shape"]["dim"]

                if len(dim) == 1:
                    linkGrp.create_dataset("%s.b" % layerName, data=paramIdx)
                    paramGrp.create_dataset(str(paramIdx), data=param, compression=compress)
                else:
                    W = param.reshape(dim).T
                    linkGrp.create_dataset("%s.W" % layerName, data=paramIdx)
                    paramGrp.create_dataset(str(paramIdx), data=W, compression=compress)

                paramIdx += 1

        elif layertype == "BatchNorm":
            dim = blobs[0]["shape"]["dim"][0]

            mean = blobs[0]["data"].reshape((1, dim, 1, 1)).copy()
            var = blobs[1]["data"].reshape((1, dim, 1, 1)).copy()

            if len(blobs) > 2:
                scale = blobs[2]["data"][0]
                if scale > 0.0:
                    scale = 1.0 / scale

                mean *= scale
                var *= scale

            if kwargs.get("batchNormVarInverse"):
                var = 1 / np.sqrt(var + kwargs["eps"])

            attrGrp.create_dataset("%s.mean" % layerName, data=mean)
            attrGrp.create_dataset("%s.var" % layerName, data=var)

        elif layertype == "Scale":
            if i > 0 and layers[i - 1]["type"] == "BatchNorm":
                dim = blobs[0]["shape"]["dim"][0]
                lastLayerName = "%s.%s" % (netName, layers[i - 1]["name"])

                scale = blobs[0]["data"].reshape((1, dim, 1, 1))
                linkGrp.create_dataset("%s.scale" % lastLayerName, data=paramIdx)
                paramGrp.create_dataset(str(paramIdx), data=scale, compression=compress)
                paramIdx += 1

                if len(blobs) > 1:
                    bias = blobs[1]["data"].reshape((1, dim, 1, 1))
                    linkGrp.create_dataset("%s.bias" % lastLayerName, data=paramIdx)
                    paramGrp.create_dataset(str(paramIdx), data=bias, compression=compress)
                    paramIdx += 1

        elif layertype == "PReLU":
            slopes = blobs[0]["data"]
            linkGrp.create_dataset("%s.slopes" % layerName, data=paramIdx)
            paramGrp.create_dataset(str(paramIdx), data=slopes, compression=compress)
            paramIdx += 1


def convert(caffemodel, hdfpath, netName=None, compress="gzip", **kwargs):
    """Import a .caffemodel into a PuzzleLib-format HDF5 checkpoint."""
    js = loadNetParameter(caffemodel)
    js2hdf(js, hdfpath, compress=compress, netName=netName, **kwargs)
