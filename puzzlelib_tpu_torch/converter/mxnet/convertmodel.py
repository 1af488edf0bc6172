"""MXNet .params/.json -> PuzzleLib HDF5 weight importer (counterpart of
``puzzlelib_tpu/converter/mxnet/convertmodel.py``).

``readHeader``, ``readData`` and ``readKeys`` read the NDArray list file in
that order; ``buildHdf`` writes the JAX package's layout (``links``,
``params``, ``attrs``) into a path (opened with ``h5py``, imported only
then) or an open store: any object answering ``create_group`` and
``create_dataset`` as an ``h5py`` group does.
"""

import os
import json
import struct
import enum

import numpy as np

from puzzlelib_tpu_torch import hdf as hdfcodec


class TypeFlag(enum.Enum):
    kFloat32 = 0
    kFloat64 = 1
    kFloat16 = 2
    kUint8 = 3
    kInt32 = 4


_DTYPES = {
    TypeFlag.kFloat32: np.float32,
    TypeFlag.kFloat64: np.float64,
    TypeFlag.kFloat16: np.float16,
    TypeFlag.kUint8: np.uint8,
    TypeFlag.kInt32: np.int32,
}


def readHeader(file):
    magic, reserved = struct.unpack("<QQ", file.read(16))

    if magic != 0x112:
        raise ValueError("Bad mxnet params magic 0x%x" % magic)


def readData(file):
    tensors = []
    ntensors = struct.unpack("<Q", file.read(8))[0]

    for _ in range(ntensors):
        ndim = struct.unpack("<I", file.read(4))[0]
        shape = struct.unpack("<" + "I" * ndim, file.read(4 * ndim))

        devtype, devid, typeflag = struct.unpack("<iii", file.read(12))
        dtype = _DTYPES[TypeFlag(typeflag)]

        count = int(np.prod(shape)) if shape else 1
        tensor = np.frombuffer(file.read(count * np.dtype(dtype).itemsize), dtype=dtype).reshape(shape)

        tensors.append(tensor)

    return tensors


def readKeys(file):
    keys = []
    nkeys = struct.unpack("<Q", file.read(8))[0]

    for _ in range(nkeys):
        length = struct.unpack("<Q", file.read(8))[0]
        keys.append(file.read(length).decode())

    return keys


def loadSymbols(symbolsname):
    with open(symbolsname) as file:
        return json.loads(file.read())


def buildHdf(keys, tensors, symbols, hdf, modelname, compress="gzip"):
    hdf, owned = hdfcodec.openStore(hdf, "w")

    try:
        _fillStore(dict(zip(keys, tensors)), symbols, hdf, modelname, compress)

    finally:
        if owned:
            hdf.close()


def _fillStore(table, symbols, hdf, modelname, compress):
    linkGrp = hdf.create_group("links")
    paramGrp = hdf.create_group("params")
    attrGrp = hdf.create_group("attrs")

    paramIdx = 0

    def addParam(link, tensor):
        nonlocal paramIdx

        linkGrp.create_dataset(link, data=paramIdx)
        paramGrp.create_dataset(str(paramIdx), data=tensor, compression=compress)
        paramIdx += 1

    for node in symbols["nodes"]:
        name = node["name"]
        layerName = "%s.%s" % (modelname, name)
        op = node["op"]

        if op == "Convolution":
            if ("arg:%s_weight" % name) in table:
                addParam("%s.W" % layerName, table["arg:%s_weight" % name])

            if ("arg:%s_bias" % name) in table:
                bias = table["arg:%s_bias" % name]
                addParam("%s.b" % layerName, bias.reshape(1, bias.shape[0], 1, 1))

        elif op == "BatchNorm":
            if ("arg:%s_gamma" % name) in table:
                scale = table["arg:%s_gamma" % name]
                addParam("%s.scale" % layerName, scale.reshape(1, scale.shape[0], 1, 1))

            if ("arg:%s_beta" % name) in table:
                bias = table["arg:%s_beta" % name]
                addParam("%s.bias" % layerName, bias.reshape(1, bias.shape[0], 1, 1))

            if ("aux:%s_moving_mean" % name) in table:
                mean = table["aux:%s_moving_mean" % name]
                attrGrp.create_dataset("%s.mean" % layerName, data=mean.reshape(1, mean.shape[0], 1, 1))

            if ("aux:%s_moving_var" % name) in table:
                var = table["aux:%s_moving_var" % name]
                attrGrp.create_dataset("%s.var" % layerName, data=var.reshape(1, var.shape[0], 1, 1))

        elif op == "FullyConnected":
            if ("arg:%s_weight" % name) in table:
                addParam("%s.W" % layerName, table["arg:%s_weight" % name].T)

            if ("arg:%s_bias" % name) in table:
                addParam("%s.b" % layerName, table["arg:%s_bias" % name])


def convert(paramsname, symbolsname, hdfpath=None, modelname=None, compress="gzip"):
    with open(paramsname, mode="rb") as file:
        readHeader(file)
        tensors = readData(file)
        keys = readKeys(file)

    symbols = loadSymbols(symbolsname)

    if modelname is None:
        modelname = os.path.basename(os.path.splitext(paramsname)[0])

    if hdfpath is None:
        hdfpath = os.path.splitext(paramsname)[0] + ".hdf"

    buildHdf(keys, tensors, symbols, hdfpath, modelname, compress=compress)
    return hdfpath
