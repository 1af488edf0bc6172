"""OpenPose COCO, the multi-stage pose net (counterpart of
``puzzlelib_tpu/models/nets/openposecoco.py``): a VGG-like stem of 12 3x3
convs and three max-pools down to 128 maps at an eighth of the input's
side, then six stages of two branches each (38 maps of part affinity fields
and 19 of part confidence maps), every stage after the first fed the
``Concat`` of the stage before's two branches and the stem's 128 features
(185 maps).  The stages nest as the reference builds them: each big block
wraps the block before it as its ``prenet``, so the returned tree and its
module and variable names are the reference's.  Every conv is built with
the "none" scheme, as there.

Weights come from ``puzzlelib_tpu_torch.convert.paramsFromNumpy`` or from
the HDF5 checkpoint at ``modelpath``."""

from puzzlelib_tpu_torch.containers import Sequential, Parallel
from puzzlelib_tpu_torch.modules import Conv2D, Activation, relu, MaxPool2D, Replicate, Identity, Concat


def buildSmallBranch(inplace=True, num=1):
    branch = Sequential()

    for i in range(1, 4):
        branch.append(Conv2D(128, 128, 3, pad=1, initscheme="none", name="conv5_%d_CPM_L%d" % (i, num)))
        branch.append(Activation(relu, inplace=inplace, name="relu5_%d_CPM_L%d" % (i, num)))

    branch.append(Conv2D(128, 512, 1, initscheme="none", name="conv5_4_CPM_L%d" % num))
    branch.append(Activation(relu, inplace=inplace, name="relu5_4_CPM_L%d" % num))
    branch.append(Conv2D(512, 19 * (3 - num), 1, initscheme="none", name="conv5_5_CPM_L%d" % num))

    return branch


def buildSmallBlock(inplace=True):
    block = Sequential()
    block.append(Replicate(3))

    left = buildSmallBranch(inplace=inplace, num=1)
    right = buildSmallBranch(inplace=inplace, num=2)
    shortcut = Sequential().append(Identity())

    block.append(Parallel().append(left).append(right).append(shortcut))
    block.append(Concat(axis=1, name="concat_stage2"))

    return block


def buildBranch(inmaps=185, inplace=True, num=1, stage=2):
    branch = Sequential()

    for i in range(1, 6):
        maps = inmaps if i == 1 else 128
        branch.append(Conv2D(maps, 128, 7, pad=3, initscheme="none", name="Mconv%d_stage%d_L%d" % (i, stage, num)))
        branch.append(Activation(relu, inplace=inplace, name="Mrelu%d_stage%d_L%d" % (i, stage, num)))

    branch.append(Conv2D(128, 128, 1, initscheme="none", name="Mconv6_stage%d_L%d" % (stage, num)))
    branch.append(Activation(relu, inplace=inplace, name="Mrelu6_stage%d_L%d" % (stage, num)))
    branch.append(Conv2D(128, 19 * (3 - num), 1, initscheme="none", name="Mconv7_stage%d_L%d" % (stage, num)))

    return branch


def buildBall(stage=2, inplace=True):
    ball = Sequential()
    ball.append(Replicate(2))

    left = buildBranch(stage=stage, num=1, inplace=inplace)
    right = buildBranch(stage=stage, num=2, inplace=inplace)

    ball.append(Parallel().append(left).append(right))
    ball.append(Concat(axis=1))

    return ball


def buildBigBlock(stage=2, prenet=None, inplace=True):
    block = Sequential()
    block.append(Replicate(2))

    shortcut = Sequential().append(Identity())

    if prenet is None:
        ball = buildBall(stage=stage, inplace=inplace)
    else:
        ball = prenet
        ball.extend(buildBall(stage=stage, inplace=inplace))

    block.append(Parallel().append(ball).append(shortcut))
    block.append(Concat(axis=1, name="concat_stage%d" % (stage + 1)))

    return block


# the VGG-like stem: (inmaps, outmaps, convname) per conv, a name = a pool
_STEM = [
    (3, 64, "conv1_1"), (64, 64, "conv1_2"), "pool1_stage1",
    (64, 128, "conv2_1"), (128, 128, "conv2_2"), "pool2_stage1",
    (128, 256, "conv3_1"), (256, 256, "conv3_2"), (256, 256, "conv3_3"), (256, 256, "conv3_4"), "pool3_stage1",
    (256, 512, "conv4_1"), (512, 512, "conv4_2"),
]


def loadCOCO(modelpath, name="", inplace=False):
    net = Sequential(name)

    for entry in _STEM:
        if isinstance(entry, str):
            net.append(MaxPool2D(name=entry))
            continue

        inmaps, outmaps, convname = entry
        net.append(Conv2D(inmaps, outmaps, 3, pad=1, initscheme="none", name=convname))
        net.append(Activation(relu, name=convname.replace("conv", "relu"), inplace=inplace))

    net.append(Conv2D(512, 256, 3, pad=1, initscheme="none", name="conv4_3_CPM"))
    net.append(Activation(relu, name="relu4_3_CPM"))
    net.append(Conv2D(256, 128, 3, pad=1, initscheme="none", name="conv4_4_CPM"))
    net.append(Activation(relu, name="relu4_4_CPM"))

    block = buildSmallBlock(inplace=inplace)
    for stage in range(2, 6):
        block = buildBigBlock(stage=stage, prenet=block, inplace=inplace)

    net.extend(block)

    net.append(Replicate(2))
    net.append(Parallel().append(
        buildBranch(stage=6, num=2, inplace=inplace)
    ).append(
        buildBranch(stage=6, num=1, inplace=inplace))
    )
    net.append(Concat(axis=1))

    if modelpath is not None:
        net.load(modelpath, assumeUniqueNames=True)

    return net
