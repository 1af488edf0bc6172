"""ResNet-50/101/152 (counterpart of ``puzzlelib_tpu/models/nets/resnet.py``):
a 7x7 stride-2 conv with its batch norm and relu, a 3x3 max-pool, then four
stages of bottleneck blocks (1x1, 3x3, 1x1 convs, each with a batch norm,
the stride on the first 1x1) whose input comes back through a shortcut
(``Replicate`` -> ``Parallel(branch, shortcut)`` -> ``Add`` -> relu), a 7x7
average pool and ``fc1000``, 224x224x3 in, with the reference's module,
variable and attribute names.  The convs carry no bias.

Weights come from the init scheme or, through
``puzzlelib_tpu_torch.convert.paramsFromNumpy`` and ``attrsFromNumpy``
(the batch norms' running stats), from tables of arrays, or from the HDF5 checkpoint
at ``modelpath``.  ``actInplace`` and
``bnInplace`` default to False: ``Replicate`` hands one tensor to both
branches, so an inplace layer in the branch would write the shortcut's
input, and a batch norm refuses ``inplace`` in train mode."""

import string

from puzzlelib_tpu_torch.containers import Parallel, Sequential
from puzzlelib_tpu_torch.modules import (
    Activation, Add, AvgPool2D, BatchNorm2D, Conv2D, Flatten, Identity, Linear, MaxPool2D, Replicate, SoftMax, relu
)


def residMiniBlock(inmaps, outmaps, size, stride, pad, blockname, mininame, addAct, actInplace, bnInplace,
                   initscheme):
    block = Sequential()

    block.append(Conv2D(
        inmaps, outmaps, size, stride=stride, pad=pad, useBias=False, initscheme=initscheme,
        name="res%s_branch%s" % (blockname, mininame)
    ))
    block.append(BatchNorm2D(outmaps, name="bn%s_branch%s" % (blockname, mininame), inplace=bnInplace))

    if addAct:
        block.append(Activation(relu, inplace=actInplace, name="res%s_branch%s_relu" % (blockname, mininame)))

    return block


def residBlock(inmaps, hmaps, stride, blockname, convShortcut, actInplace, bnInplace, initscheme):
    branch = Sequential()
    branch.extend(residMiniBlock(inmaps, hmaps, 1, stride, 0, blockname, "2a", True,
                                 actInplace, bnInplace, initscheme))
    branch.extend(residMiniBlock(hmaps, hmaps, 3, 1, 1, blockname, "2b", True,
                                 actInplace, bnInplace, initscheme))
    branch.extend(residMiniBlock(hmaps, 4 * hmaps, 1, 1, 0, blockname, "2c", False,
                                 actInplace, bnInplace, initscheme))

    shortcut = Sequential()
    if convShortcut:
        shortcut.extend(residMiniBlock(inmaps, 4 * hmaps, 1, stride, 0, blockname, "1", False,
                                       actInplace, bnInplace, initscheme))
    else:
        shortcut.append(Identity())

    block = Sequential()
    block.append(Replicate(2))
    block.append(Parallel().append(branch).append(shortcut))
    block.append(Add())
    block.append(Activation(relu, inplace=actInplace))

    return block


def loadResNet(modelpath, layers, actInplace=False, bnInplace=False, initscheme="none", name=None):
    if layers == "50":
        name = "ResNet-50" if name is None else name
        level3names = ["3%s" % alpha for alpha in string.ascii_lowercase[1:4]]
        level4names = ["4%s" % alpha for alpha in string.ascii_lowercase[1:6]]

    elif layers == "101":
        name = "ResNet-101" if name is None else name
        level3names = ["3b%s" % num for num in range(1, 4)]
        level4names = ["4b%s" % num for num in range(1, 23)]

    elif layers == "152":
        name = "ResNet-152" if name is None else name
        level3names = ["3b%s" % num for num in range(1, 8)]
        level4names = ["4b%s" % num for num in range(1, 36)]

    else:
        raise ValueError("Unsupported ResNet layers mode")

    net = Sequential(name=name)

    net.append(Conv2D(3, 64, 7, stride=2, pad=3, name="conv1", initscheme=initscheme, useBias=False))
    net.append(BatchNorm2D(64, name="bn_conv1", inplace=bnInplace))
    net.append(Activation(relu, inplace=actInplace, name="conv1_relu"))
    net.append(MaxPool2D(3, 2, name="pool1"))

    net.extend(residBlock(64, 64, 1, "2a", True, actInplace, bnInplace, initscheme))
    net.extend(residBlock(256, 64, 1, "2b", False, actInplace, bnInplace, initscheme))
    net.extend(residBlock(256, 64, 1, "2c", False, actInplace, bnInplace, initscheme))

    net.extend(residBlock(256, 128, 2, "3a", True, actInplace, bnInplace, initscheme))
    for blockname in level3names:
        net.extend(residBlock(512, 128, 1, blockname, False, actInplace, bnInplace, initscheme))

    net.extend(residBlock(512, 256, 2, "4a", True, actInplace, bnInplace, initscheme))
    for blockname in level4names:
        net.extend(residBlock(1024, 256, 1, blockname, False, actInplace, bnInplace, initscheme))

    net.extend(residBlock(1024, 512, 2, "5a", True, actInplace, bnInplace, initscheme))
    net.extend(residBlock(2048, 512, 1, "5b", False, actInplace, bnInplace, initscheme))
    net.extend(residBlock(2048, 512, 1, "5c", False, actInplace, bnInplace, initscheme))

    net.append(AvgPool2D(7, 1))
    net.append(Flatten())
    net.append(Linear(2048, 1000, initscheme=initscheme, name="fc1000"))
    net.append(SoftMax())

    if modelpath is not None:
        net.load(modelpath, assumeUniqueNames=True)

    return net
