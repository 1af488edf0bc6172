"""Mini-YOLO, the detection backbone (counterpart of
``puzzlelib_tpu/models/nets/miniyolo.py``): 24 convs in five blocks, each
followed by a leaky relu of slope 0.01 and the first four blocks by a 2x2
max-pool, then ``fc25`` (its width from the flattened 448 x 448 x 3 input's
map, 1024 x 7 x 7), ``fc26`` of 4096, ``fc27`` of ``numOutput`` and a
SoftMax.  The net is fixed at 448 x 448: ``fc25`` takes 50176 inputs.

Weights come from the init scheme or, through
``puzzlelib_tpu_torch.convert.paramsFromNumpy``, from a table of arrays,
or from the HDF5 checkpoint at ``modelpath``."""

import numpy as np

from puzzlelib_tpu_torch.containers import Sequential
from puzzlelib_tpu_torch.modules import Conv2D, Activation, relu, leakyRelu, MaxPool2D, Flatten, Linear, SoftMax


def block(idx, inmaps, outmaps, sizeconv, strideconv, initscheme, actInPlace, sizepool=2, stridepool=2,
          addMaxpool=True):
    assert len(inmaps) == len(outmaps) == len(sizeconv) == len(strideconv) == len(idx)

    seq = Sequential()

    for i in range(len(inmaps)):
        seq.append(Conv2D(
            inmaps=inmaps[i], outmaps=outmaps[i], size=sizeconv[i], pad=sizeconv[i] // 2, stride=strideconv[i],
            initscheme=initscheme, dilation=1, useBias=True, name="conv%s" % idx[i]
        ))
        seq.append(Activation(leakyRelu, inplace=actInPlace, args=(0.01, )))

    if addMaxpool:
        seq.append(MaxPool2D(size=sizepool, stride=stridepool, name="conv%s_pool" % idx[-1]))

    return seq


def loadMiniYolo(modelpath, numOutput, actInplace=False, initscheme="none"):
    net = Sequential(name="YOLONet")

    net.extend(block(idx=["1"], inmaps=[3], outmaps=[64], sizeconv=[7], strideconv=[2],
                     initscheme=initscheme, actInPlace=actInplace))
    net.extend(block(idx=["2"], inmaps=[64], outmaps=[192], sizeconv=[3], strideconv=[1],
                     initscheme=initscheme, actInPlace=actInplace))

    net.extend(block(
        idx=["3", "4", "5", "6"], inmaps=[192, 128, 256, 256], outmaps=[128, 256, 256, 512],
        sizeconv=[1, 3, 1, 3], strideconv=[1, 1, 1, 1], initscheme=initscheme, actInPlace=actInplace
    ))

    net.extend(block(
        idx=["7", "8", "9", "10", "11", "12", "13", "14", "15", "16"],
        inmaps=[512, 256, 512, 256, 512, 256, 512, 256, 512, 512],
        outmaps=[256, 512, 256, 512, 256, 512, 256, 512, 512, 1024],
        sizeconv=[1, 3, 1, 3, 1, 3, 1, 3, 1, 3], strideconv=[1] * 10,
        initscheme=initscheme, actInPlace=actInplace
    ))

    net.extend(block(
        idx=["17", "18", "19", "20", "21", "22", "23", "24"],
        inmaps=[1024, 512, 1024, 512, 1024, 1024, 1024, 1024],
        outmaps=[512, 1024, 512, 1024, 1024, 1024, 1024, 1024],
        sizeconv=[1, 3, 1, 3, 3, 3, 3, 3], strideconv=[1, 1, 1, 1, 1, 2, 1, 1],
        initscheme=initscheme, actInPlace=actInplace, addMaxpool=False
    ))

    net.append(Flatten())
    insize = int(np.prod(net.dataShapeFrom((1, 3, 448, 448))))

    net.append(Linear(insize, 512, initscheme=initscheme, name="fc25"))
    net.append(Activation(relu, inplace=actInplace, name="fc_relu24"))
    net.append(Linear(512, 4096, initscheme=initscheme, name="fc26"))
    net.append(Activation(relu, inplace=actInplace, name="fc_relu25"))
    net.append(Linear(4096, numOutput, initscheme=initscheme, name="fc27"))
    net.append(SoftMax())

    if modelpath is not None:
        net.load(modelpath)

    return net
