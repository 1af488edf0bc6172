"""LeNet on the UCI handwritten-digits dataset (the counterpart of
``testlib/digitslenet.py``): scikit-learn's bundled 1797 images of 8 x 8,
upsampled to LeNet's 28 x 28, the same net topology, ``FusedTrainer`` at
batch 100 and ``Validator``, with a held-out accuracy gate of 0.97.

``loadDigits`` needs scikit-learn, imported inside it; ``prepareDigits``
turns any arrays of the dataset's shape and range into the script's splits,
and ``train`` runs the recipe on them.

Run:  python -m puzzlelib_tpu_torch.testlib.digitslenet [epochs]
"""

import sys

import numpy as np

from puzzlelib_tpu_torch.containers import Sequential
from puzzlelib_tpu_torch.cost import CrossEntropy
from puzzlelib_tpu_torch.fused import FusedTrainer
from puzzlelib_tpu_torch.handlers import Validator
from puzzlelib_tpu_torch.modules import Activation, Conv2D, Flatten, Linear, MaxPool2D, relu
from puzzlelib_tpu_torch.optimizers import MomentumSGD

SEED = 0
SPLIT = 1500
ACCURACY_GATE = 0.97


def prepareDigits(images, target):
    """(trainX, trainY, valX, valY) of the digits' ``images`` (N, 8, 8) in
    [0, 16] and ``target``: scaled to [0, 1], upsampled 3x to 24 x 24 with
    a 2-pixel border, shuffled by ``RandomState(0)``, split at 1500."""
    images = images.astype(np.float32) / 16.0
    labels = target.astype(np.int32)

    up = np.repeat(np.repeat(images, 3, axis=1), 3, axis=2)
    data = np.zeros((len(images), 1, 28, 28), np.float32)
    data[:, 0, 2:26, 2:26] = up

    rng = np.random.RandomState(0)
    order = rng.permutation(len(images))
    data, labels = data[order], labels[order]

    return data[:SPLIT], labels[:SPLIT], data[SPLIT:], labels[SPLIT:]


def loadDigits():
    from sklearn.datasets import load_digits

    digits = load_digits()
    return prepareDigits(digits.images, digits.target)


def buildLeNet():
    seq = Sequential()
    seq.append(Conv2D(1, 16, 3, pad=1, initscheme="he"))
    seq.append(MaxPool2D())
    seq.append(Activation(relu))

    seq.append(Conv2D(16, 32, 4, pad=1, initscheme="he"))
    seq.append(MaxPool2D())
    seq.append(Activation(relu))

    seq.append(Flatten())
    seq.append(Linear(32 * 6 * 6, 1024, initscheme="he"))
    seq.append(Activation(relu))
    seq.append(Linear(1024, 10))

    return seq


def buildTraining():
    """(net, trainer, validator, cost) of the script: the net from
    ``np.random.seed(SEED)``, ``MomentumSGD(0.01, 0.9)`` in global state."""
    np.random.seed(SEED)
    net = buildLeNet()

    optimizer = MomentumSGD(learnRate=0.01, momRate=0.9)
    optimizer.setupOn(net, useGlobalState=True)

    cost = CrossEntropy(maxlabels=10)
    return net, FusedTrainer(net, cost, optimizer, batchsize=100), Validator(net, cost, batchsize=99), cost


def train(trainX, trainY, valX, valY, epochs=15):
    """The script's training on the splits: the held-out accuracy after
    the last epoch."""
    _, trainer, validator, cost = buildTraining()

    accuracy = 0.0
    for epoch in range(epochs):
        trainer.trainFromHost(trainX, trainY, macroBatchSize=SPLIT, onMacroBatchFinish=lambda t: None)
        accuracy = 1.0 - validator.validateFromHost(valX, valY, macroBatchSize=len(valX))
        print("Epoch %2d: train loss %.4f, val accuracy %.4f" % (epoch + 1, cost.getMeanError(), accuracy),
              flush=True)

    return accuracy


def main(epochs=15):
    accuracy = train(*loadDigits(), epochs=epochs)

    assert accuracy >= ACCURACY_GATE, "accuracy target missed: %.4f" % accuracy
    print("final val accuracy: %.4f (>= %.2f target)" % (accuracy, ACCURACY_GATE))
    return accuracy


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 15)
