"""The UCI handwritten digits through two more of the scripts' flows (the
counterpart of ``testlib/digitsreal.py``):

- ``autoencoder``: a tied-weight autoencoder 64 -> 32 -> 64 whose decoder
  reuses the encoder's ``W`` transposed (one variable in two modules, which
  the optimizer's flat buffer steps once a step), ``MomentumSGD`` 2.0 / 0.9
  in global state, the rate times 0.95 an epoch.  Gate: reconstruction MSE
  below 0.01.
- ``lstm``: an LSTM reads each image as an 8-step sequence of rows and
  classifies the digit, ``Adam(3e-3)`` through ``FusedTrainer``.  Gate: a
  held-out accuracy of 0.95.

K1 runs the encoder's forward product and the decoder's data-gradient
product, which is untransposed; the decoder's transposed forward product
goes to the library, as every transposed ``Linear``'s does.  ``loadDigits`` needs
scikit-learn, imported inside it; ``trainAutoencoder`` and ``trainLstm``
take the prepared arrays.

Run:  python -m puzzlelib_tpu_torch.testlib.digitsreal [autoencoder|lstm|all]
"""

import sys

import numpy as np

from puzzlelib_tpu_torch.backend import gpuarray
from puzzlelib_tpu_torch.containers import Sequential
from puzzlelib_tpu_torch.cost import MSE, CrossEntropy
from puzzlelib_tpu_torch.fused import FusedTrainer
from puzzlelib_tpu_torch.handlers import Validator
from puzzlelib_tpu_torch.modules import RNN, Activation, Linear, SwapAxes, sigmoid
from puzzlelib_tpu_torch.optimizers import Adam, MomentumSGD
from puzzlelib_tpu_torch.variable import Variable

SPLIT = 1500
MSE_GATE, ACCURACY_GATE = 0.01, 0.95


def prepareDigits(images, target):
    """(images f32 (N, 8, 8) in [0, 1], labels int32), shuffled by
    ``RandomState(0)``."""
    images = images.astype(np.float32) / 16.0
    labels = target.astype(np.int32)

    rng = np.random.RandomState(0)
    order = rng.permutation(len(images))
    return images[order], labels[order]


def loadDigits():
    from sklearn.datasets import load_digits

    digits = load_digits()
    return prepareDigits(digits.images, digits.target)


def buildAutoencoder():
    """(net, optimizer): the tied autoencoder from ``np.random.seed(0)``,
    ``MomentumSGD(2.0, 0.9)`` in global state."""
    np.random.seed(0)

    net = Sequential()
    net.append(Linear(64, 32))
    net.append(Activation(sigmoid))

    decoder = Linear(32, 64, empty=True, transpose=True)
    decoder.setVar("W", net[0].vars["W"])
    decoder.setVar("b", Variable(gpuarray.zeros((64, ), dtype=np.float32)))
    net.append(decoder)

    optimizer = MomentumSGD(learnRate=2.0, momRate=0.9)
    optimizer.setupOn(net, useGlobalState=True)
    return net, optimizer


def trainAutoencoder(images, epochs=40, batchsize=100):
    """The autoencoder's training on ``images`` (N, 8, 8): the mean MSE of
    the last epoch."""
    data = images.reshape(-1, 64)
    net, optimizer = buildAutoencoder()
    mse = MSE()

    err = None
    for epoch in range(epochs):
        for i in range(data.shape[0] // batchsize):
            batch = gpuarray.to_gpu(data[i * batchsize:(i + 1) * batchsize])
            _, grad = mse(net(batch), batch)
            net.zeroGradParams()
            net.backward(grad)
            optimizer.update()
            net.reset()

        err = mse.getMeanError()
        if (epoch + 1) % 10 == 0:
            print("autoencoder epoch %2d: MSE %.5f" % (epoch + 1, err), flush=True)
        optimizer.learnRate *= 0.95

    return err


def runAutoencoder(epochs=40):
    images, _ = loadDigits()
    err = trainAutoencoder(images, epochs)

    assert err < MSE_GATE, "autoencoder MSE gate missed: %.5f" % err
    print("autoencoder final MSE %.5f (< %g gate, tied decoder weight)" % (err, MSE_GATE))
    return err


def buildLstm():
    """(net, trainer, validator, cost): the LSTM classifier from
    ``np.random.seed(1)``, ``Adam(3e-3)`` in global state."""
    np.random.seed(1)

    net = Sequential()
    net.append(SwapAxes(0, 1))
    net.append(RNN(8, 64, mode="lstm", getSequences=False))
    net.append(Linear(64, 10))

    optimizer = Adam(alpha=3e-3)
    optimizer.setupOn(net, useGlobalState=True)

    cost = CrossEntropy(maxlabels=10)
    return net, FusedTrainer(net, cost, optimizer, batchsize=100), Validator(net, cost, batchsize=99), cost


def trainLstm(images, labels, epochs=40):
    """The LSTM's training on the first 1500 images, validated on the
    rest: the held-out accuracy after the last epoch."""
    trainX, valX = images[:SPLIT], images[SPLIT:]
    trainY, valY = labels[:SPLIT], labels[SPLIT:]

    _, trainer, validator, cost = buildLstm()

    accuracy = 0.0
    for epoch in range(epochs):
        trainer.trainFromHost(trainX, trainY, macroBatchSize=SPLIT)
        accuracy = 1.0 - validator.validateFromHost(valX, valY, macroBatchSize=len(valX))
        if (epoch + 1) % 5 == 0:
            print("lstm epoch %2d: loss %.4f, val accuracy %.4f" % (epoch + 1, cost.getMeanError(), accuracy),
                  flush=True)

    return accuracy


def runLstm(epochs=40):
    accuracy = trainLstm(*loadDigits(), epochs=epochs)

    assert accuracy >= ACCURACY_GATE, "lstm accuracy gate missed: %.4f" % accuracy
    print("lstm final val accuracy %.4f (>= %.2f gate)" % (accuracy, ACCURACY_GATE))
    return accuracy


def main(which="all"):
    if which in ("autoencoder", "all"):
        runAutoencoder()
    if which in ("lstm", "all"):
        runLstm()


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "all")
