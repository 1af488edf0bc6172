"""The CIFAR-10 Network-in-Network on the UCI handwritten digits (the
counterpart of ``testlib/digitsnin.py``): the 1797 images of 8 x 8
upsampled to 3 x 32 x 32 on the host, the same net as ``cnncifar10nin``
(``buildNet``, ``standardize``) and its recipe, ``MomentumSGD`` 0.1 / 0.9
in local state with ``GradClip(1.0)`` then ``WeightDecay(1e-4)``, a linear
warm-up over 30 epochs, the rate times 0.1 after epochs 200 and 250, random
+-2 pixel shifts each epoch (``tools/dataslice.augmentShift``), and
``FusedTrainer`` grouping ``stepsPerDispatch`` steps (11: an epoch of 1500
images at batch 128).  Gate: a held-out accuracy of 0.95 after 300 epochs.

``loadDigits32`` needs scikit-learn, imported inside it;
``prepareDigits32`` turns any arrays of the dataset's shape and range into
the script's images, and ``train`` runs the recipe on them.

Run:  python -m puzzlelib_tpu_torch.testlib.digitsnin [epochs]
"""

import sys
import time

import numpy as np

from puzzlelib_tpu_torch.cost import CrossEntropy
from puzzlelib_tpu_torch.fused import FusedTrainer, FusedValidator
from puzzlelib_tpu_torch.optimizers import MomentumSGD
from puzzlelib_tpu_torch.optimizers import hooks as Hooks
from puzzlelib_tpu_torch.testlib.cnncifar10nin import buildNet, standardize
from puzzlelib_tpu_torch.tools.dataslice import augmentShift

SEED, SHIFT_SEED = 1234, 7
SPLIT = 1500
PEAK_RATE, MOM_RATE = 0.1, 0.9
CLIP, WEIGHT_DECAY = 1.0, 1e-4
WARMUP_EPOCHS, ANNEALS = 30, (200, 250)
ACCURACY_GATE = 0.95


def prepareDigits32(images, target):
    """(data f32 (N, 3, 32, 32), labels int32) of the digits' ``images``
    (N, 8, 8) in [0, 16] and ``target``: scaled to [0, 1], shuffled by
    ``RandomState(0)``, upsampled 4x by repetition, smoothed once by a 4 x 4
    box with edge padding, replicated to 3 maps."""
    images = images.astype(np.float32) / 16.0
    labels = target.astype(np.int32)

    rng = np.random.RandomState(0)
    order = rng.permutation(len(images))
    images, labels = images[order], labels[order]

    up = np.repeat(np.repeat(images, 4, axis=1), 4, axis=2)
    kernel = np.ones((4, 4), np.float32) / 16.0

    padded = np.pad(up, ((0, 0), (2, 2), (2, 2)), mode="edge")
    smooth = np.zeros_like(up)
    for dy in range(4):
        for dx in range(4):
            smooth += kernel[dy, dx] * padded[:, dy:dy + 32, dx:dx + 32]

    data = np.repeat(smooth[:, None], 3, axis=1)
    return np.ascontiguousarray(data), labels


def loadDigits32():
    from sklearn.datasets import load_digits

    digits = load_digits()
    return prepareDigits32(digits.images, digits.target)


def learnRate(epoch):
    """The rate of ``epoch`` (from 1): the linear warm-up to 0.1, times
    0.1 after each anneal."""
    rate = PEAK_RATE * min(1.0, epoch / float(WARMUP_EPOCHS))
    for anneal in ANNEALS:
        rate *= 0.1 if epoch > anneal else 1.0

    return rate


def buildTraining(stepsPerDispatch=11):
    """(net, optimizer, trainer, validator) of the script: the NIN from
    ``np.random.seed(SEED)``."""
    np.random.seed(SEED)
    net = buildNet()

    optimizer = MomentumSGD(learnRate=PEAK_RATE, momRate=MOM_RATE)
    optimizer.addHook(Hooks.GradClip(CLIP))
    optimizer.addHook(Hooks.WeightDecay(WEIGHT_DECAY))
    optimizer.setupOn(net, useGlobalState=False)

    cost = CrossEntropy(maxlabels=10)
    trainer = FusedTrainer(net, cost, optimizer, batchsize=128, stepsPerDispatch=stepsPerDispatch)
    return net, optimizer, trainer, FusedValidator(net, cost, batchsize=128)


def train(data, labels, epochs=300, stepsPerDispatch=11):
    """The script's training on ``data`` (N, 3, 32, 32), standardized in
    place, the first 1500 images trained on and the rest validated: (the
    train error of each epoch, the held-out error of each)."""
    data = standardize(data)
    print("Loaded digits->32x32x3: train %d, val %d" % (SPLIT, len(data) - SPLIT))

    _, optimizer, trainer, validator = buildTraining(stepsPerDispatch)
    augrng = np.random.RandomState(SHIFT_SEED)

    trainErrors, valErrors = [], []
    for epoch in range(1, epochs + 1):
        start = time.time()
        optimizer.learnRate = learnRate(epoch)
        trainer.trainFromHost(augmentShift(data[:SPLIT], augrng), labels[:SPLIT], macroBatchSize=SPLIT)

        valErrors.append(validator.validateFromHost(data[SPLIT:], labels[SPLIT:], macroBatchSize=len(data) - SPLIT))
        trainErrors.append(trainer.cost.getMeanError())
        print("Finished epoch %d out of %d. Train error: %.5f, val error: %.5f (%.1fs)"
              % (epoch, epochs, trainErrors[-1], valErrors[-1], time.time() - start), flush=True)

        if epoch in ANNEALS:
            print("Annealing learn rate from next epoch", flush=True)

    return trainErrors, valErrors


def main(epochs=300, stepsPerDispatch=11):
    _, valErrors = train(*loadDigits32(), epochs=epochs, stepsPerDispatch=stepsPerDispatch)

    accuracy = 1.0 - valErrors[-1]
    print("Final held-out accuracy: %.4f" % accuracy)
    assert accuracy >= ACCURACY_GATE, "NIN did not converge: %.4f" % accuracy
    return accuracy


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 300)
