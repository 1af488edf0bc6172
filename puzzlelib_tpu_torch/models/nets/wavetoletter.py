"""Wave2Letter, the CTC speech recogniser (counterpart of
``puzzlelib_tpu/models/nets/wavetoletter.py``): 19 blocks of a 1-d conv,
each but the last followed by a batch norm (epsilon 1e-3) and ``clip``
(0, 20), the first 18 by a dropout of 0.2 to 0.4; the padded blocks pad in
reflect mode before an unpadded conv.  The first block halves the time
axis (stride 2), the 17th dilates by 2.  At ``inmaps=161``, ``nlabels=29``
it holds 106.8 M parameters; frames (N, inmaps, T) give scores (N, nlabels,
T / 2), which ``ops.ctc`` takes as (T / 2, N, nlabels) after a
``backend.memory.moveaxis``.

Weights come from the init scheme or, through
``puzzlelib_tpu_torch.convert.paramsFromNumpy`` and ``attrsFromNumpy``
(the batch norms' running stats), from tables of arrays; loading a
checkpoint file comes with the checkpoint port."""

from puzzlelib_tpu_torch.containers import Sequential
from puzzlelib_tpu_torch.modules import Activation, BatchNorm1D, Conv1D, Dropout, Pad1D, clip


def convBlock(inmaps, outmaps, size, stride, pad, dropout, initscheme, dilation=1, bnAct=True, name=None):
    block = Sequential()

    if pad > 0:
        block.append(Pad1D(pad, mode="reflect"))

    block.append(Conv1D(
        inmaps, outmaps, size=size, stride=stride, pad=0, dilation=dilation, useBias=True,
        initscheme=initscheme, name="%s_conv" % name
    ))

    if bnAct:
        block.append(BatchNorm1D(outmaps, epsilon=0.001, name="%s_bn" % name))
        block.append(Activation(clip, args=(0.0, 20.0)))

    if dropout > 0.0:
        block.append(Dropout(p=dropout))

    return block


# (inmaps, outmaps, size, stride, pad, dropout, dilation, bnAct)
_LAYOUT = [
    (None, 256, 11, 2, 5, 0.2, 1, True),
    (256, 256, 11, 1, 5, 0.2, 1, True), (256, 256, 11, 1, 5, 0.2, 1, True), (256, 256, 11, 1, 5, 0.2, 1, True),
    (256, 384, 13, 1, 6, 0.2, 1, True), (384, 384, 13, 1, 6, 0.2, 1, True), (384, 384, 13, 1, 6, 0.2, 1, True),
    (384, 512, 17, 1, 8, 0.2, 1, True), (512, 512, 17, 1, 8, 0.2, 1, True), (512, 512, 17, 1, 8, 0.2, 1, True),
    (512, 640, 21, 1, 10, 0.3, 1, True), (640, 640, 21, 1, 10, 0.3, 1, True), (640, 640, 21, 1, 10, 0.3, 1, True),
    (640, 768, 25, 1, 12, 0.3, 1, True), (768, 768, 25, 1, 12, 0.3, 1, True), (768, 768, 25, 1, 12, 0.3, 1, True),
    (768, 896, 29, 1, 28, 0.4, 2, True),
    (896, 1024, 1, 1, 0, 0.4, 1, True),
    (1024, None, 1, 1, 0, 0.0, 1, False),
]


def loadW2L(modelpath, inmaps, nlabels, initscheme=None, name="w2l"):
    """Wave2Letter for ``inmaps`` input features and ``nlabels`` labels
    (blank included)."""
    if modelpath is not None:
        raise NotImplementedError("loading a checkpoint is not ported yet; build with modelpath=None and "
                                  "load weights with convert.paramsFromNumpy and attrsFromNumpy")

    net = Sequential(name=name)

    for i, (inm, outm, size, stride, pad, dropout, dilation, bnAct) in enumerate(_LAYOUT):
        inm = inmaps if inm is None else inm
        outm = nlabels if outm is None else outm

        net.extend(convBlock(
            inm, outm, size=size, stride=stride, pad=pad, dropout=dropout, initscheme=initscheme,
            dilation=dilation, bnAct=bnAct, name="conv1d_%d" % i
        ))

    return net
