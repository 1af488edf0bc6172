"""VGG-11/16/19 (counterpart of ``puzzlelib_tpu/models/nets/vgg.py``), with
max or average pooling.  Weights come from the init scheme or, through
``puzzlelib_tpu_torch.convert.paramsFromNumpy``, from a table of arrays,
or from the HDF5 checkpoint at ``modelpath``."""

import numpy as np

from puzzlelib_tpu_torch.containers import Sequential
from puzzlelib_tpu_torch.modules import Conv2D, Activation, relu, AvgPool2D, MaxPool2D, Flatten, Linear, SoftMax


# per stage: (maps, convs-in-11, convs-in-16, convs-in-19)
_STAGES = [
    (64, 1, 2, 2),
    (128, 1, 2, 2),
    (256, 2, 3, 4),
    (512, 2, 3, 4),
    (512, 2, 3, 4),
]


def loadVGG(modelpath, layers, poolmode="max", initscheme="none", withLinear=True, actInplace=False, name=None):
    if poolmode == "avg":
        pool = AvgPool2D
    elif poolmode == "max":
        pool = MaxPool2D
    else:
        raise ValueError("Unsupported pool mode")

    if layers not in {"11", "16", "19"}:
        raise ValueError("Unsupported VGG layers mode")

    if name is None:
        name = "VGG_ILSVRC_%s_layers" % layers

    depthIdx = {"11": 1, "16": 2, "19": 3}[layers]

    net = Sequential(name=name)

    inmaps = 3
    for stage, (maps, *depths) in enumerate(_STAGES, start=1):
        nconvs = depths[depthIdx - 1]

        for i in range(1, nconvs + 1):
            net.append(Conv2D(inmaps, maps, 3, pad=1, initscheme=initscheme, name="conv%d_%d" % (stage, i)))
            net.append(Activation(relu, inplace=actInplace, name="relu%d_%d" % (stage, i)))
            inmaps = maps

        net.append(pool(2, 2, name="pool%d" % stage))

    if withLinear:
        net.append(Flatten())
        insize = int(np.prod(net.dataShapeFrom((1, 3, 224, 224))))

        net.append(Linear(insize, 4096, initscheme=initscheme, name="fc6"))
        net.append(Activation(relu, inplace=actInplace, name="relu6"))
        net.append(Linear(4096, 4096, initscheme=initscheme, name="fc7"))
        net.append(Activation(relu, inplace=actInplace, name="relu7"))
        net.append(Linear(4096, 1000, initscheme=initscheme, name="fc8"))
        net.append(SoftMax())

    if modelpath is not None:
        net.load(modelpath)

    return net
