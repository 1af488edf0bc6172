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
the host.  ``convertRnnCheckpoint``, which rewrites an HDF5 checkpoint,
comes with the port's checkpoints.
"""

import numpy as np

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
