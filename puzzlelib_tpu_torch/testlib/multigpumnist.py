"""Data-parallel LeNet on MNIST over a grid of nodes (the counterpart of
``testlib/multigpumnist.py``): LeNet from ``np.random.seed(1234)`` on every
node, ``MomentumSGD`` at 0.1 / 0.9 with the node's ``nodeinfo`` in global
state (node 0's weights broadcast at the setup, the gradients averaged over
the grid at each update), ``CrossEntropy``, a ``Trainer`` at 128 //
gridsize a node, so that a step of the grid takes a global batch of 128.
Node i trains on the i-th contiguous part of ``data[:trainsize]`` and
validates on the i-th part of the ``valsize`` rows after it; the train and
validation errors are averaged over the grid (``meanValue``) and the rate is
multiplied by 0.9 after each epoch.

``train`` takes the arrays; ``main`` runs it on two nodes, each loading MNIST
through ``MnistLoader`` from its own cache, as the reference's nodes do.
Run it with ``python -m puzzlelib_tpu_torch.testlib.multigpumnist``."""

import numpy as np

from puzzlelib_tpu_torch.cost import CrossEntropy
from puzzlelib_tpu_torch.datasets import MnistLoader
from puzzlelib_tpu_torch.grid import runGrid
from puzzlelib_tpu_torch.handlers import Trainer, Validator
from puzzlelib_tpu_torch.models.nets.lenet import loadLeNet
from puzzlelib_tpu_torch.optimizers import MomentumSGD

SEED = 1234
LEARN_RATE, MOM_RATE = 0.1, 0.9
GLOBAL_BATCH = 128
EPOCHS = 15
TRAIN_SIZE, VAL_SIZE = 60000, 10000


def train(nodeinfo, data, labels, epochs=EPOCHS, trainsize=TRAIN_SIZE, valsize=VAL_SIZE, onBatchFinish=None):
    """The recipe on this node; returns (net, [(global train error, global
    validation error)] an epoch).  ``onBatchFinish`` is the Trainer's
    per-step callback."""
    np.random.seed(SEED)
    net = loadLeNet(None, initscheme=None)

    optimizer = MomentumSGD(learnRate=LEARN_RATE, momRate=MOM_RATE, nodeinfo=nodeinfo)
    optimizer.setupOn(net, useGlobalState=True)

    cost = CrossEntropy(maxlabels=10)
    trainer = Trainer(net, cost, optimizer, onBatchFinish=onBatchFinish, batchsize=GLOBAL_BATCH // nodeinfo.gridsize)
    validator = Validator(net, cost)

    trainpart, valpart = trainsize // nodeinfo.gridsize, valsize // nodeinfo.gridsize
    mine = slice(nodeinfo.index * trainpart, (nodeinfo.index + 1) * trainpart)
    myVal = slice(trainsize + nodeinfo.index * valpart, trainsize + (nodeinfo.index + 1) * valpart)

    history = []
    for epoch in range(1, epochs + 1):
        trainer.trainFromHost(data[mine], labels[mine], macroBatchSize=trainpart)

        trerr = nodeinfo.meanValue(cost.getMeanError())
        if nodeinfo.index == 0:
            print("Epoch %s global train error: %s" % (epoch, trerr))

        valerr = nodeinfo.meanValue(validator.validateFromHost(data[myVal], labels[myVal], macroBatchSize=valpart))
        if nodeinfo.index == 0:
            print("Epoch %s global accuracy: %s" % (epoch, 1.0 - valerr))

        history.append((trerr, valerr))
        optimizer.learnRate *= 0.9

    return net, history


def node(nodeinfo, datapath, epochs=EPOCHS):
    """A node of ``main``: MNIST loaded from the node's own cache, then
    ``train``."""
    data, labels = MnistLoader(cachename="mnist-%s.hdf" % nodeinfo.index).load(path=datapath)
    data, labels = data[:], labels[:]
    print("[%s]: Loaded mnist" % nodeinfo.index)

    train(nodeinfo, data, labels, epochs=epochs)


def main(size=2, datapath="testdata/", epochs=EPOCHS):
    runGrid(node, size, datapath, epochs=epochs)


if __name__ == "__main__":
    main()
