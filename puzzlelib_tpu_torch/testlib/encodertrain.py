"""The tied-weight MNIST autoencoder (the counterpart of
``testlib/encodertrain.py``): 784 -> 256 with relu in place and dropout,
the decoder reusing the encoder's ``W`` transposed, ``MomentumSGD`` at
10.0 / 0.5 in global state, the rate times 0.8 an epoch, the encoder's
filters written to ``encoder.png`` every 5 epochs (``visual.showFilters``,
which needs PIL).  K1 runs the encoder's forward product and the
decoder's data-gradient product, which is untransposed; the decoder's
transposed forward product runs on the library.

``main`` loads MNIST through ``MnistLoader().load`` (its HDF5 cache needs
``h5py``), then ``train`` runs the recipe on the images as rows.
"""

import numpy as np

from puzzlelib_tpu_torch.backend import gpuarray
from puzzlelib_tpu_torch.containers import Sequential
from puzzlelib_tpu_torch.cost import MSE
from puzzlelib_tpu_torch.datasets import MnistLoader
from puzzlelib_tpu_torch.modules import Activation, Dropout, Linear, relu
from puzzlelib_tpu_torch.optimizers import MomentumSGD
from puzzlelib_tpu_torch.variable import Variable
from puzzlelib_tpu_torch.visual import showFilters

HIDDEN = 256
PIXELS = 784
SEED = 1234
LEARN_RATE, MOM_RATE, DECAY = 10.0, 0.5, 0.8
BATCH = 100
DUMP_EVERY = 5


def buildEncoder():
    net = Sequential()

    net.append(Linear(PIXELS, HIDDEN))
    net.append(Activation(relu, inplace=True))
    net.append(Dropout())

    decoder = Linear(HIDDEN, PIXELS, empty=True, transpose=True)
    decoder.setVar("W", net[0].vars["W"])
    decoder.setVar("b", Variable(gpuarray.zeros((PIXELS, ), dtype=np.float32)))
    net.append(decoder)

    return net


def trainEpoch(net, mse, optimizer, data, batchsize):
    for i in range(data.shape[0] // batchsize):
        batch = data[i * batchsize:(i + 1) * batchsize]

        _, grad = mse(net(batch), batch)

        net.zeroGradParams()
        net.backward(grad)
        optimizer.update()


def train(data, epochs=40, datapath="testdata/"):
    """The script's training on ``data`` (N, 784) f32 rows: the net from
    ``np.random.seed(SEED)``; returns the mean error of each epoch."""
    np.random.seed(SEED)
    net = buildEncoder()

    optimizer = MomentumSGD()
    optimizer.setupOn(net, useGlobalState=True)
    optimizer.learnRate, optimizer.momRate = LEARN_RATE, MOM_RATE

    data = gpuarray.to_gpu(data)
    mse = MSE()

    errors = []
    for epoch in range(1, epochs + 1):
        trainEpoch(net, mse, optimizer, data, batchsize=BATCH)
        optimizer.learnRate *= DECAY

        errors.append(mse.getMeanError())
        print("Finished epoch %d" % epoch)
        print("Error: %s" % errors[-1])
        mse.resetAccumulator()

        if epoch % DUMP_EVERY == 0:
            firstLayer = gpuarray.get(net[0].W).T
            showFilters(firstLayer.reshape(16, 16, 28, 28), "%s/encoder.png" % datapath)

    return errors


def main(epochs=40, datapath="testdata/"):
    data, _ = MnistLoader().load(path=datapath)
    data = data[:].reshape(data.shape[0], -1)
    print("Loaded mnist")

    return train(data, epochs, datapath)


if __name__ == "__main__":
    main()
