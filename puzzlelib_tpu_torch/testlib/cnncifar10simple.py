"""A simple CNN on CIFAR-10 (the counterpart of
``testlib/cnncifar10simple.py``): three Gaussian-initialized conv + pool
blocks, two linear layers, ``MomentumSGD`` 0.01 / 0.9 with the rate halved
on a validation plateau.  The filters of the three convs are written to
``conv1.png`` (as RGB tiles) to ``conv3.png`` in ``datapath`` after each
epoch (``visual.py``)."""

import math

import numpy as np

from puzzlelib_tpu_torch.containers import Sequential
from puzzlelib_tpu_torch.cost import CrossEntropy
from puzzlelib_tpu_torch.datasets import Cifar10Loader
from puzzlelib_tpu_torch.handlers import Trainer, Validator
from puzzlelib_tpu_torch.modules import Activation, Conv2D, Flatten, Linear, MaxPool2D, relu
from puzzlelib_tpu_torch.optimizers import MomentumSGD
from puzzlelib_tpu_torch.visual import showFilters, showImageBasedFilters

SEED = 1234
LEARN_RATE, MOM_RATE = 0.01, 0.9

# (inmaps, outmaps, wscale) per conv block; all 5x5 pad 2 + 3x2 maxpool + relu
CONV_BLOCKS = [(3, 32, 0.0001), (32, 32, 0.01), (32, 64, 0.01)]


def buildNet():
    seq = Sequential()

    for inmaps, outmaps, wscale in CONV_BLOCKS:
        seq.append(Conv2D(inmaps, outmaps, 5, pad=2, wscale=wscale, initscheme="gaussian"))
        seq.append(MaxPool2D(3, 2))
        seq.append(Activation(relu))

    seq.append(Flatten())

    flat = seq.dataShapeFrom((1, 3, 32, 32))[1]
    seq.append(Linear(flat, 64, wscale=0.1, initscheme="gaussian"))
    seq.append(Activation(relu))
    seq.append(Linear(64, 10, wscale=0.1, initscheme="gaussian"))

    return seq


def dumpFilters(net, datapath):
    for layer, dump in ((0, showImageBasedFilters), (3, showFilters), (6, showFilters)):
        dump(net[layer].W, "%s/conv%d.png" % (datapath, layer // 3 + 1))


def buildTraining():
    """(net, optimizer, trainer, validator) of the script: the net from
    ``np.random.seed(SEED)``."""
    np.random.seed(SEED)
    net = buildNet()

    optimizer = MomentumSGD()
    optimizer.setupOn(net, useGlobalState=True)
    optimizer.learnRate, optimizer.momRate = LEARN_RATE, MOM_RATE

    cost = CrossEntropy(maxlabels=10)
    return net, optimizer, Trainer(net, cost, optimizer), Validator(net, cost)


def main(epochs=25, datapath="testdata/"):
    data, labels = Cifar10Loader().load(path=datapath)
    data, labels = data[:], labels[:]
    print("Loaded cifar10")

    net, optimizer, trainer, validator = buildTraining()
    plateau = math.inf

    for _ in range(epochs):
        trainer.trainFromHost(
            data[:50000], labels[:50000], macroBatchSize=50000,
            onMacroBatchFinish=lambda train: print("Train error: %s" % train.cost.getMeanError())
        )

        valerror = validator.validateFromHost(data[50000:], labels[50000:], macroBatchSize=10000)
        print("Accuracy: %s" % (1.0 - valerror))

        if valerror >= plateau:
            optimizer.learnRate *= 0.5
            print("Lowered learn rate: %s" % optimizer.learnRate)

        plateau = valerror
        dumpFilters(net, datapath)


if __name__ == "__main__":
    main()
