"""LSTM sentiment classification on IMDB (the counterpart of
``testlib/rnnimdbtrain.py``): embedding 128, one LSTM of 128 with 0.2
dropout, Adam 1e-3, 15 epochs; the net is ``tools/sequenceslice.py``'s
``buildLSTM``."""

from puzzlelib_tpu_torch.testlib._imdb import batchPlan, runSentiment
from puzzlelib_tpu_torch.tools.sequenceslice import buildLSTM

NUMWORDS, MAXLEN = 20000, 80


def buildNet(numwords=NUMWORDS, maxlen=MAXLEN, hintBatchsize=None):
    return buildLSTM(numwords, maxlen, hintBatchsize=hintBatchsize)


def main(epochs=15, datapath="testdata/"):
    hint, _ = batchPlan()
    runSentiment(lambda: buildNet(hintBatchsize=hint), NUMWORDS, MAXLEN, epochs, datapath)


if __name__ == "__main__":
    main()
