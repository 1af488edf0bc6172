"""RNN flat-weight interchange with cuDNN-layout checkpoints (counterpart of
``puzzlelib_tpu/converter/rnnweights.py``).

cuDNN's legacy packed format, which the reference's checkpoints hold:

  * all weight matrices first, pseudo-layer-major, linear-layer order within
    a layer (relu/tanh: [W, R]; LSTM: [Wi Wf Wc Wo | Ri Rf Rc Ro];
    GRU: [Wr Wi Wh | Rr Ri Rh]), each row-major (hsize, input width);
  * then all biases in the same traversal order, (hsize, ) each.

The port's layout (``backend/rnn.py`` ``RnnDesc.layout``, the JAX package's)
interleaves [matrix, bias] per linear layer.  ``convertRnnWeights`` moves a
flat blob between the two; both are numpy arrays, so the conversion runs on
the host.  ``convertRnnCheckpoint`` rewrites the RNN blobs of an HDF5
checkpoint into a copy of the file (it needs ``h5py``).
"""

import shutil

import numpy as np

from puzzlelib_tpu_torch import hdf as hdfcodec
from puzzlelib_tpu_torch.backend.rnn import _LINLAYERS, RnnDesc


def _pseudoLayers(layers, direction):
    return layers * (2 if direction == "bi" else 1)


def _inputWidth(layer, insize, hsize, direction):
    """Input width of a pseudo-layer: the raw input for level 0, the
    concatenated hidden state above it."""
    dirs = 2 if direction == "bi" else 1
    return insize if layer // dirs == 0 else hsize * dirs


def cudnnRnnLayout(mode, insize, hsize, layers, direction="uni"):
    """([(pseudo-layer, param name, offset, shape)], size) of the cuDNN
    packed blob: every layer's matrices first, then the biases in the same
    order."""
    inNames, recNames = _LINLAYERS[mode]
    entries = []

    offset = 0
    for layer in range(_pseudoLayers(layers, direction)):
        width = _inputWidth(layer, insize, hsize, direction)

        for name in inNames:
            entries.append((layer, name, offset, (hsize, width)))
            offset += hsize * width

        for name in recNames:
            entries.append((layer, name, offset, (hsize, hsize)))
            offset += hsize * hsize

    for layer in range(_pseudoLayers(layers, direction)):
        for name in inNames + recNames:
            entries.append((layer, "b" + name, offset, (hsize, )))
            offset += hsize

    return entries, offset


def convertRnnWeights(flatW, mode, insize, hsize, layers, direction="uni", source="cudnn"):
    """A flat RNN weight blob in the other layout: source="cudnn" takes a
    cuDNN blob to the port's layout, source="native" the port's to cuDNN's."""
    flatW = np.asarray(flatW).ravel()

    desc = RnnDesc(insize, hsize, layers, mode, direction)
    cudnnEntries, cudnnSize = cudnnRnnLayout(mode, insize, hsize, layers, direction)

    if desc.wsize != cudnnSize or flatW.size != cudnnSize:
        raise ValueError("RNN weight blob of %d values, the layouts hold %d and %d" %
                         (flatW.size, desc.wsize, cudnnSize))

    if source not in ("cudnn", "native"):
        raise ValueError("Unknown source layout '%s'" % source)

    out = np.empty_like(flatW)

    for layer, name, cudnnOffset, shape in cudnnEntries:
        nativeOffset, nativeShape = desc.layout[layer][name]
        count = int(np.prod(shape))

        if source == "cudnn":
            out[nativeOffset:nativeOffset + count] = flatW[cudnnOffset:cudnnOffset + count]
        else:
            out[cudnnOffset:cudnnOffset + count] = flatW[nativeOffset:nativeOffset + count]

    return out


def convertRnnCheckpoint(hdfPath, outPath, mode, insize, hsize, layers, direction="uni",
                         paramKey=None, source="cudnn"):
    """Copy the checkpoint ``hdfPath`` to ``outPath`` and convert its RNN
    weight datasets there: every ``params/<idx>`` dataset whose size is the
    packed blob's (or only the one named by ``paramKey``)."""
    h5py = hdfcodec._h5py()

    shutil.copyfile(hdfPath, outPath)

    _, wsize = cudnnRnnLayout(mode, insize, hsize, layers, direction)

    with h5py.File(outPath, "r+") as hdf:
        grp = hdf["params"]
        keys = [paramKey] if paramKey is not None else list(grp.keys())

        for key in keys:
            blob = np.asarray(grp[key])
            if blob.size == wsize:
                grp[key][...] = convertRnnWeights(
                    blob, mode, insize, hsize, layers, direction, source=source
                ).reshape(blob.shape)

    return outPath
