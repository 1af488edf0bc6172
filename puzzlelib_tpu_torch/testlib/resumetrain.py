"""Checkpoint and resume (the counterpart of ``testlib/resumetrain.py``):
LeNet on MNIST through ``MnistLoader``, ``MomentumSGD`` at 0.1 / 0.9 in
global state, trained for ``epochs`` epochs; then the net and the
optimizer are saved to ``net.hdf`` and ``optimizer.hdf`` in ``datapath``,
loaded back (in place: the variables stay views of the optimizer's flat
buffer) and trained for ``epochs`` more, the files removed at the end."""

import os

import numpy as np

from puzzlelib_tpu_torch.cost import CrossEntropy
from puzzlelib_tpu_torch.datasets import MnistLoader
from puzzlelib_tpu_torch.handlers import Trainer, Validator
from puzzlelib_tpu_torch.models.nets.lenet import loadLeNet
from puzzlelib_tpu_torch.optimizers import MomentumSGD


def train(net, optimizer, data, labels, epochs):
    cost = CrossEntropy(maxlabels=10)

    trainer = Trainer(net, cost, optimizer)
    validator = Validator(net, cost)

    for _ in range(epochs):
        trainer.trainFromHost(
            data[:60000], labels[:60000], macroBatchSize=60000,
            onMacroBatchFinish=lambda tr: print("Train error: %s" % tr.cost.getMeanError())
        )
        print("Accuracy: %s" % (1.0 - validator.validateFromHost(data[60000:], labels[60000:],
                                                                 macroBatchSize=10000)))

        optimizer.learnRate *= 0.9
        print("Reduced optimizer learn rate to %s" % optimizer.learnRate)


def main(epochs=10, datapath="testdata/"):
    mnist = MnistLoader()
    data, labels = mnist.load(path=datapath)
    data, labels = data[:], labels[:]
    print("Loaded mnist")

    np.random.seed(1234)
    net = loadLeNet(None, initscheme=None)

    optimizer = MomentumSGD()
    optimizer.setupOn(net, useGlobalState=True)
    optimizer.learnRate = 0.1
    optimizer.momRate = 0.9

    print("Training for %s epochs ..." % epochs)
    train(net, optimizer, data, labels, epochs)

    print("Saving net and optimizer ...")
    net.save(os.path.join(datapath, "net.hdf"))
    optimizer.save(os.path.join(datapath, "optimizer.hdf"))

    print("Reloading net and optimizer ...")
    net.load(os.path.join(datapath, "net.hdf"))
    optimizer.load(os.path.join(datapath, "optimizer.hdf"))

    print("Continuing training for %s epochs ..." % epochs)
    train(net, optimizer, data, labels, epochs)

    os.remove(os.path.join(datapath, "net.hdf"))
    os.remove(os.path.join(datapath, "optimizer.hdf"))


if __name__ == "__main__":
    main()
