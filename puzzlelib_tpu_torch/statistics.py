"""Classification statistics: the confusion matrix, precision, recall and
accuracy (a copy of ``puzzlelib_tpu/statistics.py``, which the port may not
import)."""

import numpy as np


def confusion(labels, predictions, dim=0, log=True):
    if dim <= 0:
        dim = int(max(
            max((int(l) for l in labels), default=-1),
            max((int(p) for p in predictions), default=-1)
        )) + 1

    cm = [[0] * dim for _ in range(dim)]

    for lbl, pred in zip(labels, predictions):
        cm[int(lbl)][int(pred)] += 1

    if log:
        print("Confusion Matrix:")
        for row in cm:
            print(str(row))

    return cm


def precision(cm, log=True, verbose=True):
    dim = len(cm)
    prs = []

    for i in range(dim):
        colsum = sum(cm[j][i] for j in range(dim))
        tpr = 1.0 if colsum == 0 else cm[i][i] / colsum
        prs.append(tpr)

        if log and verbose:
            print("Precision on class %s: %s" % (i, tpr))

    pr = sum(prs) / dim

    if log:
        print("Precision mean: %s" % pr)

    return pr, prs


def recall(cm, log=True, verbose=True):
    dim = len(cm)
    rcs = []

    for i in range(dim):
        rowsum = sum(cm[i])
        trc = 1.0 if rowsum == 0 else cm[i][i] / rowsum
        rcs.append(trc)

        if log and verbose:
            print("Recall on class %d: %f" % (i, trc))

    rc = sum(rcs) / dim

    if log:
        print("Recall mean: %s" % rc)

    return rc, rcs


def accuracy(cm, log=True):
    dim = len(cm)

    total = sum(sum(row) for row in cm)
    correct = sum(cm[i][i] for i in range(dim))

    acc = correct / total

    if log:
        print("Accuracy: %s" % acc)

    return acc


def fullstats(labels, predictions, dim=0, printing=True, verbose=True):
    cm = confusion(labels, predictions, dim, printing)
    pr, prs = precision(cm, printing, verbose)
    rc, rcs = recall(cm, printing, verbose)

    return cm, pr, rc, prs, rcs
