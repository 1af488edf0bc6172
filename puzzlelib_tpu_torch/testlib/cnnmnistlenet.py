"""LeNet on MNIST (the counterpart of ``testlib/cnnmnistlenet.py``):
``MomentumSGD`` at 0.1 / 0.9 in global state, ``CrossEntropy``, trained on
``data[:60000]`` (the 10000 test images, then 50000 training ones: the
loader's order) and validated on the last 10000, the rate times 0.9 an
epoch.  The filters of the two convs are written to ``conv1.png`` and
``conv2.png`` in ``datapath`` after each epoch (``visual.showFilters``)."""

import numpy as np

from puzzlelib_tpu_torch.cost import CrossEntropy
from puzzlelib_tpu_torch.datasets import MnistLoader
from puzzlelib_tpu_torch.handlers import Trainer, Validator
from puzzlelib_tpu_torch.models.nets.lenet import loadLeNet
from puzzlelib_tpu_torch.optimizers import MomentumSGD
from puzzlelib_tpu_torch.visual import showFilters

SEED = 1234
LEARN_RATE, MOM_RATE = 0.1, 0.9
TRAIN_SPLIT = 60000


def buildTraining():
    """(net, optimizer, trainer, validator) of the script: LeNet from
    ``np.random.seed(SEED)``."""
    np.random.seed(SEED)
    net = loadLeNet(None, initscheme=None)

    optimizer = MomentumSGD()
    optimizer.setupOn(net, useGlobalState=True)
    optimizer.learnRate = LEARN_RATE
    optimizer.momRate = MOM_RATE

    cost = CrossEntropy(maxlabels=10)
    return net, optimizer, Trainer(net, cost, optimizer), Validator(net, cost)


def dumpFilters(net, datapath):
    showFilters(net[0].W, "%s/conv1.png" % datapath)
    showFilters(net[3].W, "%s/conv2.png" % datapath)


def main(epochs=15, datapath="testdata/"):
    mnist = MnistLoader()
    data, labels = mnist.load(path=datapath)
    data, labels = data[:], labels[:]
    print("Loaded mnist")

    net, optimizer, trainer, validator = buildTraining()

    for _ in range(epochs):
        trainer.trainFromHost(
            data[:TRAIN_SPLIT], labels[:TRAIN_SPLIT], macroBatchSize=TRAIN_SPLIT,
            onMacroBatchFinish=lambda train: print("Train error: %s" % train.cost.getMeanError())
        )
        print("Accuracy: %s" % (1.0 - validator.validateFromHost(data[TRAIN_SPLIT:], labels[TRAIN_SPLIT:],
                                                                 macroBatchSize=10000)))

        optimizer.learnRate *= 0.9

        dumpFilters(net, datapath)


if __name__ == "__main__":
    main()
