"""Shared IMDB sentiment-training harness of the three IMDB scripts (the
counterpart of ``testlib/_imdb.py``): load IMDB, train with Adam 1e-3 and
BCE for N epochs, report the accuracy each epoch."""

from puzzlelib_tpu_torch.backend import dnn as Dnn
from puzzlelib_tpu_torch.cost import BCE
from puzzlelib_tpu_torch.datasets import IMDBLoader
from puzzlelib_tpu_torch.handlers import Trainer, Validator
from puzzlelib_tpu_torch.optimizers import Adam

TRAIN_SPLIT = 25000
ALPHA = 1e-3


def batchPlan():
    """(hintBatchsize, batchsize): persistent-kernel hints where supported
    (the port has none, so (None, 32))."""
    return (40, 40) if Dnn.deviceSupportsBatchHint() else (None, 32)


def buildTraining(net):
    """(trainer, validator) of the scripts' recipe on ``net``: Adam(1e-3)
    in global state, BCE, ``batchPlan``'s batch."""
    optimizer = Adam(alpha=ALPHA)
    optimizer.setupOn(net, useGlobalState=True)

    cost = BCE()
    _, batchsize = batchPlan()
    return Trainer(net, cost, optimizer, batchsize=batchsize), Validator(net, cost, batchsize=batchsize)


def runSentiment(buildNet, numwords, maxlen, epochs=15, datapath="testdata/"):
    data, labels, _ = IMDBLoader(numwords=numwords, maxlen=maxlen).load(path=datapath)
    data, labels = data[:], labels[:]
    print("Loaded IMDB")

    trainer, validator = buildTraining(buildNet())

    print("Started training ...")
    for _ in range(epochs):
        trainer.trainFromHost(
            data[:TRAIN_SPLIT], labels[:TRAIN_SPLIT], macroBatchSize=TRAIN_SPLIT,
            onMacroBatchFinish=lambda tr: print("Train error: %s" % tr.cost.getMeanError())
        )

        valerr = validator.validateFromHost(data[TRAIN_SPLIT:], labels[TRAIN_SPLIT:],
                                            macroBatchSize=TRAIN_SPLIT)
        print("Accuracy: %s" % (1.0 - valerr))
