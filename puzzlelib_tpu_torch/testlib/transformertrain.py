"""Transformer sentiment on IMDB (the counterpart of
``testlib/transformertrain.py``): the pre-norm encoder classifier (20000
words, 80 tokens, embedding 128, 4 heads, 2 layers) with ``Adam(1e-3)`` in
global state, ``FusedTrainer`` at 4 steps a dispatch and ``Validator``, the
rate times 0.9 an epoch.

``attnAlgo`` picks the attention core ("xla", the composed attention, as
the script; "flash", kernels K4, K5a and K5b, which take bf16 and f16 only),
and ``dtype`` the net's type (None: f32, as the script).  ``main`` loads IMDB
through ``IMDBLoader().load`` (its HDF5 cache needs ``h5py``), then ``train``
runs the recipe on the arrays.
"""

from puzzlelib_tpu_torch.cost import CrossEntropy
from puzzlelib_tpu_torch.datasets import IMDBLoader
from puzzlelib_tpu_torch.fused import FusedTrainer
from puzzlelib_tpu_torch.handlers import Validator
from puzzlelib_tpu_torch.models.nets.transformer import buildTransformerClassifier
from puzzlelib_tpu_torch.optimizers import Adam

NUMWORDS, MAXLEN = 20000, 80
TRAIN_SPLIT = 25000
STEPS_PER_DISPATCH = 4


def buildNet(numwords, maxlen, attnAlgo="xla"):
    return buildTransformerClassifier(
        numwords, maxlen, embsize=128, nheads=4, nlayers=2, nclasses=2,
        attnAlgo=attnAlgo, name="imdb-transformer"
    )


def buildTraining(batchsize=64, attnAlgo="xla", dtype=None):
    """(net, optimizer, trainer, validator) of the script."""
    net = buildNet(NUMWORDS, MAXLEN, attnAlgo)
    if dtype is not None:
        net.calcMode(dtype)

    optimizer = Adam(alpha=1e-3)
    optimizer.setupOn(net, useGlobalState=True)

    cost = CrossEntropy(maxlabels=2)
    trainer = FusedTrainer(net, cost, optimizer, batchsize=batchsize, stepsPerDispatch=STEPS_PER_DISPATCH)
    return net, optimizer, trainer, Validator(net, cost, batchsize=batchsize)


def train(data, labels, epochs=10, batchsize=64, attnAlgo="xla", dtype=None, split=TRAIN_SPLIT):
    """The script's training on ``split`` rows of ``data`` and validation
    on the rest: (the train error of each epoch, the accuracy of each)."""
    _, optimizer, trainer, validator = buildTraining(batchsize, attnAlgo, dtype)
    trainErrors, accuracies = [], []

    def onTrained(handler):
        trainErrors.append(handler.cost.getMeanError())
        print("Train error: %s" % trainErrors[-1])

    print("Started training ...")
    for i in range(epochs):
        trainer.trainFromHost(data[:split], labels[:split].astype("int32"), macroBatchSize=split,
                              onMacroBatchFinish=onTrained)

        accuracies.append(1.0 - validator.validateFromHost(data[split:], labels[split:].astype("int32"),
                                                           macroBatchSize=split))
        print("Epoch %d accuracy: %s" % (i + 1, accuracies[-1]))

        optimizer.alpha *= 0.9

    return trainErrors, accuracies


def main(epochs=10, datapath="testdata/", batchsize=64, attnAlgo="xla", dtype=None):
    data, labels, _ = IMDBLoader(numwords=NUMWORDS, maxlen=MAXLEN).load(path=datapath)
    print("Loaded IMDB")

    return train(data, labels, epochs, batchsize, attnAlgo, dtype)


if __name__ == "__main__":
    main()
