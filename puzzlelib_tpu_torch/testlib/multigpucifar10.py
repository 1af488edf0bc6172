"""Data-parallel CIFAR-10 over a grid of nodes (the counterpart of
``testlib/multigpucifar10.py``): ``cnncifar10simple.buildNet`` from
``np.random.seed(1234)`` on every node, ``MomentumSGD`` at 0.01 / 0.9 with
the node's ``nodeinfo`` in global state, ``CrossEntropy``, a ``Trainer`` at
128 // gridsize a node.  The last ``valsize`` rows validate, the rest train;
node i takes the i-th contiguous part of each.  The errors are averaged over
the grid (``meanValue``) and the rate is halved where the global validation
error did not fall.

``train`` takes the arrays; ``main`` runs it on two nodes, each loading
CIFAR-10 through ``Cifar10Loader`` from its own cache, as the reference's
nodes do.  Run it with ``python -m puzzlelib_tpu_torch.testlib.multigpucifar10``."""

import math

import numpy as np

from puzzlelib_tpu_torch.cost import CrossEntropy
from puzzlelib_tpu_torch.datasets import Cifar10Loader
from puzzlelib_tpu_torch.grid import runGrid
from puzzlelib_tpu_torch.handlers import Trainer, Validator
from puzzlelib_tpu_torch.optimizers import MomentumSGD
from puzzlelib_tpu_torch.testlib.cnncifar10simple import buildNet

SEED = 1234
LEARN_RATE, MOM_RATE = 0.01, 0.9
GLOBAL_BATCH = 128
EPOCHS = 25
VAL_SIZE = 10000


def train(nodeinfo, data, labels, epochs=EPOCHS, valsize=VAL_SIZE, verbose=False, onBatchFinish=None):
    """The recipe on this node; returns (net, [(global train error, global
    validation error)] an epoch).  ``onBatchFinish`` is the Trainer's
    per-step callback."""
    np.random.seed(SEED)
    net = buildNet()

    optimizer = MomentumSGD(learnRate=LEARN_RATE, momRate=MOM_RATE, nodeinfo=nodeinfo)
    optimizer.setupOn(net, useGlobalState=True)

    cost = CrossEntropy(maxlabels=10)
    trainer = Trainer(net, cost, optimizer, onBatchFinish=onBatchFinish, batchsize=GLOBAL_BATCH // nodeinfo.gridsize)
    validator = Validator(net, cost)

    trainsize = data.shape[0] - valsize
    trainPer, valPer = trainsize // nodeinfo.gridsize, valsize // nodeinfo.gridsize

    mine = slice(nodeinfo.index * trainPer, (nodeinfo.index + 1) * trainPer)
    myVal = slice(trainsize + nodeinfo.index * valPer, trainsize + (nodeinfo.index + 1) * valPer)

    plateau, history = math.inf, []
    for epoch in range(1, epochs + 1):
        trainer.trainFromHost(data[mine], labels[mine], macroBatchSize=trainPer)

        localTrainErr = cost.getMeanError()
        if verbose:
            print("[%s]: Epoch %s local train error: %s" % (nodeinfo.index, epoch, localTrainErr))

        globalTrainErr = nodeinfo.meanValue(localTrainErr)
        if nodeinfo.index == 0:
            print("Epoch %s global train error: %s" % (epoch, globalTrainErr))

        localValErr = validator.validateFromHost(data[myVal], labels[myVal], macroBatchSize=valPer)
        if verbose:
            print("[%s]: Epoch %s local accuracy: %s" % (nodeinfo.index, epoch, 1.0 - localValErr))

        globalValErr = nodeinfo.meanValue(localValErr)
        if nodeinfo.index == 0:
            print("Epoch %s global accuracy: %s" % (epoch, 1.0 - globalValErr))

        if globalValErr >= plateau:
            optimizer.learnRate *= 0.5
            print("[%s]: Lowered learn rate: %s" % (nodeinfo.index, optimizer.learnRate))

        plateau = globalValErr
        history.append((globalTrainErr, globalValErr))

    return net, history


def node(nodeinfo, datapath, epochs=EPOCHS, verbose=True):
    """A node of ``main``: CIFAR-10 loaded from the node's own cache, then
    ``train``."""
    data, labels = Cifar10Loader(cachename="cifar10-%s.hdf" % nodeinfo.index).load(path=datapath)
    data, labels = data[:], labels[:]
    print("[%s]: Loaded cifar10" % nodeinfo.index)

    train(nodeinfo, data, labels, epochs=epochs, verbose=verbose)


def main(size=2, datapath="testdata/", epochs=EPOCHS):
    runGrid(node, size, datapath, epochs=epochs)


if __name__ == "__main__":
    main()
