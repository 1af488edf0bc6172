"""Network-in-Network on CIFAR-10 (the counterpart of
``testlib/cnncifar10nin.py``): the three NIN blocks of
``tools/cnnslice.py`` (``buildNet``), per-feature standardization,
``MomentumSGD`` 0.1 / 0.9 with ``WeightDecay(1e-4)``, the rate times 0.1 at
epochs 60 and 80.  The filters of conv1 (as RGB tiles), conv2 and conv3
are written to ``ninconv1.png`` to ``ninconv3.png`` in ``datapath`` after
each epoch (``visual.py``)."""

import numpy as np

from puzzlelib_tpu_torch.cost import CrossEntropy
from puzzlelib_tpu_torch.datasets import Cifar10Loader
from puzzlelib_tpu_torch.handlers import Trainer, Validator
from puzzlelib_tpu_torch.optimizers import MomentumSGD
from puzzlelib_tpu_torch.optimizers import hooks as Hooks
from puzzlelib_tpu_torch.tools.cnnslice import buildNet
from puzzlelib_tpu_torch.visual import showFilters, showImageBasedFilters

SEED = 1234
LEARN_RATE, MOM_RATE, WEIGHT_DECAY = 0.1, 0.9, 1e-4
MACRO_BATCH = 25000


def standardize(data):
    flat = data.reshape(data.shape[0], -1)
    flat -= flat.mean(axis=0, keepdims=True) + 1e-8
    flat /= flat.std(axis=0, keepdims=True) + 1e-5

    return flat.reshape(data.shape[0], 3, 32, 32)


def buildTraining():
    """(net, optimizer, trainer, validator) of the script: the NIN from
    ``np.random.seed(SEED)``."""
    np.random.seed(SEED)
    net = buildNet()

    optimizer = MomentumSGD(learnRate=LEARN_RATE, momRate=MOM_RATE)
    optimizer.addHook(Hooks.WeightDecay(WEIGHT_DECAY))
    optimizer.setupOn(net, useGlobalState=True)

    cost = CrossEntropy(maxlabels=10)
    return net, optimizer, Trainer(net, cost, optimizer), Validator(net, cost)


def dumpFilters(net, datapath):
    showImageBasedFilters(net["conv1"].W, "%s/ninconv1.png" % datapath)
    showFilters(net["conv2"].W, "%s/ninconv2.png" % datapath)
    showFilters(net["conv3"].W, "%s/ninconv3.png" % datapath)


def main(epochs=100, datapath="testdata/"):
    data, labels = Cifar10Loader().load(path=datapath)
    data, labels = standardize(data[:]), labels[:]
    print("Loaded cifar10")

    net, optimizer, trainer, validator = buildTraining()

    for epoch in range(1, epochs + 1):
        trainer.trainFromHost(
            data[:50000], labels[:50000], macroBatchSize=MACRO_BATCH,
            onMacroBatchFinish=lambda train: print("Train error: %s" % train.cost.getMeanError())
        )

        valerror = validator.validateFromHost(data[50000:], labels[50000:], macroBatchSize=10000)
        print("Finished epoch %d out of %d. Val error: %s" % (epoch, epochs, valerror))

        if epoch in (60, 80):
            optimizer.learnRate *= 0.1
            print("Lowered learn rate: %s" % optimizer.learnRate)

        dumpFilters(net, datapath)


if __name__ == "__main__":
    main()
