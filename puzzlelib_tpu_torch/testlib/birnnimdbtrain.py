"""BiLSTM sentiment classification on IMDB (the counterpart of
``testlib/birnnimdbtrain.py``): embedding 128, a bidirectional LSTM of 64
(concatenated to 128), dropout 0.5, Adam 1e-3; the net is
``tools/sequenceslice.py``'s ``buildBiLSTM``."""

from puzzlelib_tpu_torch.testlib._imdb import batchPlan, runSentiment
from puzzlelib_tpu_torch.tools.sequenceslice import buildBiLSTM

NUMWORDS, MAXLEN = 20000, 100


def buildNet(numwords=NUMWORDS, maxlen=MAXLEN, hintBatchsize=None):
    return buildBiLSTM(numwords, maxlen, hintBatchsize=hintBatchsize)


def main(epochs=15, datapath="testdata/"):
    hint, _ = batchPlan()
    runSentiment(lambda: buildNet(hintBatchsize=hint), NUMWORDS, MAXLEN, epochs, datapath)


if __name__ == "__main__":
    main()
