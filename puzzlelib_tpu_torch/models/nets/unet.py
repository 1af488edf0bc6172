"""U-Net (counterpart of ``puzzlelib_tpu/models/nets/unet.py``): five
encoder blocks of two 3x3 convs with relus (64 to 1024 maps, each but the
first after a 2x2 max-pool, the fourth and fifth with a dropout), the fifth
ending in a 2x2 stride-2 deconv; four decoder blocks, each fed the
``Concat`` of the level below's output and the level's own input, which
comes back through a shortcut (``Replicate`` -> ``Parallel(next level,
shortcut)`` -> ``Concat``), each of the first three ending in a deconv and a
3x3 conv; a 1x1 ``score`` conv to one map and a sigmoid, with the
reference's module and variable names.  The deconvs carry no bias.

Weights come from the init scheme or, through
``puzzlelib_tpu_torch.convert.paramsFromNumpy``, from a table of arrays,
or from the HDF5 checkpoint at ``modelpath``."""

from puzzlelib_tpu_torch.containers import Sequential, Parallel
from puzzlelib_tpu_torch.modules import (
    Conv2D, MaxPool2D, Activation, relu, sigmoid, Deconv2D, Replicate, Concat, Identity, Dropout
)


def blockA(blockId, actInplace, initscheme):
    inmaps = 1 if blockId == 1 else 2 ** (4 + blockId)
    outmaps = 2 ** (5 + blockId)

    block = Sequential(name="block_%d" % blockId)

    if blockId > 1:
        block.append(MaxPool2D(size=2, stride=2, name="pool%d" % (blockId - 1, )))

    block.append(Conv2D(inmaps, outmaps, 3, pad=1, initscheme=initscheme, name="conv_%d_1" % blockId))
    block.append(Activation(relu, inplace=actInplace, name="relu%d" % (2 * blockId - 1, )))
    block.append(Conv2D(outmaps, outmaps, 3, pad=1, initscheme=initscheme, name="conv_%d_2" % blockId))
    block.append(Activation(relu, inplace=actInplace, name="relu%d" % (2 * blockId, )))

    if blockId >= 4:
        block.append(Dropout(name="drop%d" % blockId))

    if blockId == 5:
        block.append(Deconv2D(1024, 512, size=2, stride=2, useBias=False, initscheme=initscheme, name="upscore1"))
        block.append(Activation(relu, inplace=actInplace, name="relu11"))

    return block


def shortcut(blockId):
    return Sequential(name="shortcut_%d" % blockId).append(Identity())


def blockB(blockId, actInplace, initscheme):
    inmaps = 2 ** (16 - blockId)
    outmaps = inmaps // 2
    reluId = 12 + (blockId - 6) * 3

    block = Sequential(name="block_%d" % blockId)

    block.append(Conv2D(inmaps, outmaps, 3, pad=1, initscheme=initscheme, name="conv_%d_1" % blockId))
    block.append(Activation(relu, inplace=actInplace, name="relu%d" % reluId))
    block.append(Conv2D(outmaps, outmaps, 3, pad=1, initscheme=initscheme, name="conv_%d_2" % blockId))
    block.append(Activation(relu, inplace=actInplace, name="relu%d" % (reluId + 1, )))

    if blockId < 9:
        block.append(Deconv2D(
            outmaps, outmaps // 2, 2, stride=2, useBias=False, initscheme=initscheme,
            name="upscore%d" % (blockId - 4)
        ))
        block.append(Conv2D(outmaps // 2, outmaps // 2, size=3, pad=1, initscheme=initscheme,
                            name="conv_%d_3" % blockId))
        block.append(Activation(relu, inplace=actInplace, name="relu%d" % (reluId + 2)))
    else:
        block.append(Conv2D(64, 1, 1, initscheme=initscheme, name="score"))
        block.append(Activation(sigmoid, inplace=actInplace))

    return block


def loadUNet(modelpath, actInplace=False, initscheme="none"):
    net = Sequential(name="unet")

    blocksA, blocksB, shortcuts = [None], [None] * 6, [None]

    for blockId in range(1, 6):
        blocksA.append(blockA(blockId, actInplace, initscheme))
        shortcuts.append(shortcut(blockId))

    for blockId in range(6, 10):
        blocksB.append(blockB(blockId, actInplace, initscheme))

    for blockId in range(1, 5):
        blocksA[blockId].append(Replicate(2))
        blocksA[blockId].append(
            Parallel(name="fork_%d" % blockId).append(blocksA[blockId + 1]).append(shortcuts[blockId + 1])
        )

    for blockId in range(4, 0, -1):
        blocksA[blockId].append(Concat(axis=1, name="concat%d" % (5 - blockId, )))
        blocksA[blockId].extend(blocksB[10 - blockId])

    net.extend(blocksA[1])
    if modelpath is not None:
        net.load(modelpath)

    return net
