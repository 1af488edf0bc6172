"""OpenPose MPI, the multi-stage pose net of the face model (counterpart of
``puzzlelib_tpu/models/nets/openposempi.py``): a VGG-like stem of 16 3x3
convs and three max-pools down to 128 maps at an eighth of the input's
side, the first stage's 1x1 head (71 maps), then five stages, each fed the
``Concat`` of the stage before's 71 maps and the stem's 128 features (199
maps), five 7x7 convs and two 1x1 convs each.

The construction is the reference's: the builder appends the net itself
to its list of stages and appends each earlier stage into the next one, so
the returned ``Sequential`` holds the four earlier stages nested inside it,
with the reference's module and variable names and tree order.

Weights come from the default scheme or, through
``puzzlelib_tpu_torch.convert.paramsFromNumpy``, from a table of arrays,
or from the HDF5 checkpoint at ``modelpath``."""

from puzzlelib_tpu_torch.containers import Sequential, Parallel
from puzzlelib_tpu_torch.modules import Conv2D, Activation, relu, MaxPool2D, Replicate, Identity, Concat


_STEM = [
    (3, 64, "conv1_1"), (64, 64, "conv1_2"), "pool1",
    (64, 128, "conv2_1"), (128, 128, "conv2_2"), "pool2",
    (128, 256, "conv3_1"), (256, 256, "conv3_2"), (256, 256, "conv3_3"), (256, 256, "conv3_4"), "pool3",
    (256, 512, "conv4_1"), (512, 512, "conv4_2"), (512, 512, "conv4_3"), (512, 512, "conv4_4"),
    (512, 512, "conv5_1"), (512, 512, "conv5_2"),
]


def loadMPI(modelpath, name="OpenPoseFaceNet"):
    net = Sequential(name=name)

    for entry in _STEM:
        if isinstance(entry, str):
            net.append(MaxPool2D(2, 2, name=entry))
            continue

        inmaps, outmaps, convname = entry
        net.append(Conv2D(inmaps, outmaps, 3, pad=1, name=convname))
        net.append(Activation(relu, name="%s_re" % convname))

    net.append(Conv2D(512, 128, 3, pad=1, name="conv5_3_CPM"))
    net.append(Activation(relu, name="conv5_3_CPM_re"))
    net.append(Replicate(2))

    branch4 = Sequential()
    branch4.append(Conv2D(128, 512, 1, pad=0, name="conv6_1_CPM"))
    branch4.append(Activation(relu, name="conv6_1_CPM_re"))
    branch4.append(Conv2D(512, 71, 1, pad=0, name="conv6_2_CPM"))

    branches = [branch4]
    shortcuts = [Sequential().append(Identity())]

    for _ in range(4):
        branch = Sequential()
        branch.append(Replicate(2))
        branches.append(branch)
        shortcuts.append(Sequential().append(Identity()))

    # the net is the last stage: each stage takes the one before it in
    branches.append(net)
    shortcuts.append(None)

    for branchIdx, branch in enumerate(branches):
        if branchIdx == 0:
            continue

        stage = branchIdx + 1

        branch.append(Parallel().append(branches[branchIdx - 1]).append(shortcuts[branchIdx - 1]))
        branch.append(Concat(name="features_in_stage_%d" % stage, axis=1))

        for i in range(1, 6):
            maps = 199 if i == 1 else 128
            branch.append(Conv2D(maps, 128, 7, pad=3, name="Mconv%d_stage%d" % (i, stage)))
            branch.append(Activation(relu, name="Mconv%d_stage%d_re" % (i, stage)))

        branch.append(Conv2D(128, 128, 1, pad=0, name="Mconv6_stage%d" % stage))
        branch.append(Activation(relu, name="Mconv6_stage%d_re" % stage))
        branch.append(Conv2D(128, 71, 1, pad=0, name="Mconv7_stage%d" % stage))

    if modelpath is not None:
        net.load(modelpath, assumeUniqueNames=True)

    return net
