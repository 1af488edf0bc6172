"""Network-in-Network for ImageNet (counterpart of
``puzzlelib_tpu/models/nets/nin.py``): four blocks of a lead conv and two
1x1 "cccp" convs, each with a relu, pooled by 3x3 windows at stride 2
(max or average), then a 5x5 average pool of the 1000 maps, 224x224x3 in.
Weights come from the init scheme or, through
``puzzlelib_tpu_torch.convert.paramsFromNumpy``, from a table of arrays,
or from the HDF5 checkpoint at ``modelpath``."""

from puzzlelib_tpu_torch.containers import Sequential
from puzzlelib_tpu_torch.modules import Conv2D, Activation, relu, MaxPool2D, AvgPool2D, Flatten, SoftMax


# (inmaps, outmaps, size, stride, pad, convname) per conv, None = pool slot
_LAYOUT = [
    (3, 96, 11, 4, 0, "conv1"), (96, 96, 1, 1, 0, "cccp1"), (96, 96, 1, 1, 0, "cccp2"), None,
    (96, 256, 5, 1, 2, "conv2"), (256, 256, 1, 1, 0, "cccp3"), (256, 256, 1, 1, 0, "cccp4"), None,
    (256, 384, 3, 1, 1, "conv3"), (384, 384, 1, 1, 0, "cccp5"), (384, 384, 1, 1, 0, "cccp6"), None,
    (384, 1024, 3, 1, 1, "conv4-1024"), (1024, 1024, 1, 1, 0, "cccp7-1024"), (1024, 1000, 1, 1, 0, "cccp8-1024"),
]


def loadNiNImageNet(modelpath, poolmode="max", actInplace=False, initscheme="none", name="CaffeNet"):
    if poolmode == "avg":
        pool = AvgPool2D
    elif poolmode == "max":
        pool = MaxPool2D
    else:
        raise ValueError("Unsupported pool mode")

    net = Sequential(name=name)

    poolIdx, reluIdx = 1, 0
    for entry in _LAYOUT:
        if entry is None:
            net.append(pool(3, 2, name="pool%d" % poolIdx))
            poolIdx += 1
            continue

        inmaps, outmaps, size, stride, pad, convname = entry
        net.append(Conv2D(inmaps, outmaps, size, stride=stride, pad=pad, initscheme=initscheme, name=convname))
        net.append(Activation(relu, inplace=actInplace, name="relu%d" % reluIdx))
        reluIdx += 1

    net.append(AvgPool2D(5, 1, name="pool4"))
    net.append(Flatten())
    net.append(SoftMax())

    if modelpath is not None:
        net.load(modelpath)

    return net
