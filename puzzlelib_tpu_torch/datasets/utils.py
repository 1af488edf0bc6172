"""Dataset helpers (a copy of ``puzzlelib_tpu/datasets/utils.py``):
``validate`` a classifier's confusion matrix, precision, recall and
accuracy through ``Calculator``; ``permutateData``, ``splitData`` (a
validation share taken per class) and ``replicateData`` (the minority
classes oversampled up to the majority's count) on host arrays, drawing
from numpy's global stream as the reference does, so one numpy seed gives
both packages the same splits."""

import numpy as np

from puzzlelib_tpu_torch.handlers.calculator import Calculator
from puzzlelib_tpu_torch import statistics as Statistics


def getDim(labels):
    return int(np.max(labels)) + 1


def checkShape(data, labels):
    assert len(data) == len(labels)
    return len(data)


def validate(net, valData, valLabels, dim=0, batchsize=128, log=False):
    if dim == 0:
        dim = getDim(valLabels)

    confMat = np.zeros(shape=(dim, dim))
    predictions = Calculator(net, batchsize=batchsize).calcFromHost(valData)

    for i in range(predictions.shape[0]):
        confMat[valLabels[i], np.argmax(predictions[i])] += 1

    if log:
        print("Confusion matrix:\n" + str(confMat))

    precision, _ = Statistics.precision(confMat, log=log)
    recall, _ = Statistics.recall(confMat, log=log)
    accuracy = Statistics.accuracy(confMat, log=log)

    return precision, recall, accuracy


def permutateData(data, labels=None, constantMemory=False):
    perm = np.random.permutation(len(data))

    if labels is not None:
        checkShape(data, labels)
        labels[:] = np.asarray(labels)[perm]

    data[:] = np.asarray(data)[perm]
    return data, labels


def splitData(data, labels=None, dim=0, validation=0.1, permutation=True, uniformVal=True):
    if len(data) == 0:
        return None

    if permutation:
        data, labels = permutateData(data, labels)

    if labels is None:
        splitter = int(validation * len(data))
        return data[splitter:], data[:splitter]

    if dim < 1:
        dim = getDim(labels)

    counts = np.bincount(labels, minlength=dim)

    if uniformVal:
        coe = np.full(dim, int(validation * counts.min()), dtype=np.int64)
    else:
        coe = (counts * validation).astype(np.int64)

    valSize = int(coe.sum())
    trainSize = len(data) - valSize

    valData = np.empty((valSize, ) + data.shape[1:], data.dtype)
    valLabels = np.empty((valSize, ), labels.dtype)
    trainData = np.empty((trainSize, ) + data.shape[1:], data.dtype)
    trainLabels = np.empty((trainSize, ), labels.dtype)

    counter = np.zeros(dim, dtype=np.int64)
    valIdx, trainIdx = 0, 0

    for i in range(len(data)):
        lbl = labels[i]

        if counter[lbl] < coe[lbl]:
            valData[valIdx], valLabels[valIdx] = data[i], lbl
            valIdx += 1
            counter[lbl] += 1
        else:
            trainData[trainIdx], trainLabels[trainIdx] = data[i], lbl
            trainIdx += 1

    return trainData, valData, trainLabels, valLabels


def replicateData(data, labels, dim=0, permutation=True):
    """Oversample the minority classes up to the majority class's count."""
    checkShape(data, labels)

    if dim < 1:
        dim = getDim(labels)

    counts = np.bincount(labels, minlength=dim)
    top = counts.max()

    coe = np.where(counts > 0, top / np.maximum(counts, 1), 0.0)

    length = dim * top
    newData = np.empty((length, ) + data.shape[1:], data.dtype)
    newLabels = np.empty((length, ), labels.dtype)

    cur = np.zeros(dim)
    res = np.zeros(dim)
    idx = 0

    for i in range(len(data)):
        lbl = labels[i]
        cur[lbl] += coe[lbl]

        while res[lbl] < cur[lbl] - 0.1:
            newData[idx], newLabels[idx] = data[i], lbl
            idx += 1
            res[lbl] += 1

    newData, newLabels = newData[:idx], newLabels[:idx]

    if permutation:
        newData, newLabels = permutateData(newData, newLabels)

    return newData, newLabels
