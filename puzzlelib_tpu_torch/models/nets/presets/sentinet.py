"""SentiNet's turn-key training preset (counterpart of
``puzzlelib_tpu/models/nets/presets/sentinet.py``): ``buildTrainValidate``
splits the data (a tenth per class for validation), oversamples the
minority classes, builds SentiNet on sentences padded on both sides and
runs ``train``: ``AdaDelta`` in local state, ``CrossEntropy``, ``Trainer``
at batch 64 and ``Validator``, the net's convs timed for the batch's shape
first (``optimizeForShape``), one validation an epoch.

With ``saving=True`` (the default) ``train`` keeps the best net so far on
disk, in ``<temporary directory>/<net name>.hdf``, loads it back at the
end and returns (net, best accuracy); with ``saving=False`` it returns
(None, best accuracy), as the reference's does."""

import os
import tempfile

import numpy as np

from puzzlelib_tpu_torch.models.nets.sentinet import buildNet
from puzzlelib_tpu_torch.cost.crossentropy import CrossEntropy
from puzzlelib_tpu_torch.optimizers.adadelta import AdaDelta

from puzzlelib_tpu_torch.handlers.trainer import Trainer
from puzzlelib_tpu_torch.handlers.validator import Validator

from puzzlelib_tpu_torch.datasets.utils import validate, getDim, splitData, replicateData


def train(net, trainData, trainLabels, valData, valLabels, dim=0, epochs=50, epochsBeforeSaving=0, saving=True,
          printing=True, macroBatchSize=30000, optimizeNet=True):
    if dim == 0:
        dim = getDim(trainLabels)

    numOfChunks = 1
    batchsize = 64

    macroBatchSize = min(len(trainLabels), macroBatchSize)

    optimizer = AdaDelta()
    optimizer.setupOn(net)

    cost = CrossEntropy(dim)

    trainer = Trainer(net, cost, optimizer, batchsize=batchsize)
    validator = Validator(net, cost)

    if optimizeNet:
        net.optimizeForShape((batchsize, *trainData.shape[1:]))

    lowestValerror = np.inf
    valerror = np.inf

    for epoch in range(epochs):
        trainSize = trainData.shape[0]
        chunkSize = trainSize // numOfChunks

        for j in range(numOfChunks + 1):
            start = j * chunkSize
            end = min((j + 1) * chunkSize, trainSize)

            if start == end:
                continue

            trainer.trainFromHost(trainData[start:end], trainLabels[start:end], macroBatchSize=macroBatchSize)
            valerror = validator.validateFromHost(valData, valLabels, macroBatchSize=macroBatchSize)

            if printing:
                print("Epoch #%d/%d. Chunk #%d/%d. Train error: %s. Val error: %s" % (
                    epoch + 1, epochs, j + 1, numOfChunks, trainer.cost.getMeanError(), valerror))

            if lowestValerror >= valerror and epoch >= epochsBeforeSaving:
                lowestValerror = valerror

                if saving:
                    net.save(os.path.join(tempfile.gettempdir(), net.name + ".hdf"))

    bestPrecision = 1.0 - lowestValerror

    if printing:
        print("Highest accuracy: %-6f%%\n" % (100.0 * bestPrecision))

    if saving:
        net.load(os.path.join(tempfile.gettempdir(), net.name + ".hdf"))
        return net, bestPrecision

    return None, bestPrecision


def buildTrainValidate(data, labels, vocabulary=None, w2v=None, wscale=0.25, embsize=300, padding=4, dim=2,
                       sentlength=100, epochs=5, epochsBeforeSaving=0, branches=(3, 4, 5), saving=True,
                       printing=True):
    data = np.asarray(data.copy())
    labels = np.asarray(labels.copy())

    trainData, valData, trainLabels, valLabels = splitData(data, labels, validation=0.1, dim=dim)
    trainData, trainLabels = replicateData(trainData, trainLabels, dim=dim)

    net = buildNet(vocabulary, branches, w2v, sentlength + 2 * padding, embsize, wscale, dim=dim)
    net.setAttr("sentlength", sentlength)
    net.setAttr("padding", padding)

    net, accuracy = train(
        net, trainData, trainLabels, valData, valLabels, dim, epochs, epochsBeforeSaving, saving, printing
    )

    if net:
        _, _, accuracy = validate(net, valData, valLabels, dim, log=printing)

    return accuracy, net, trainData, valData, trainLabels, valLabels
