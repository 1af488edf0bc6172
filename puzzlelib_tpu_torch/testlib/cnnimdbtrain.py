"""1-d CNN sentiment classification on IMDB (the counterpart of
``testlib/cnnimdbtrain.py``): embedding 50, one Conv1D(k=3) and a global
max pool, a 250-unit head, Adam 1e-3; the net is
``tools/sequenceslice.py``'s ``buildCNN``."""

from puzzlelib_tpu_torch.testlib._imdb import runSentiment
from puzzlelib_tpu_torch.tools.sequenceslice import buildCNN

NUMWORDS, MAXLEN, EMBSIZE = 5000, 250, 50


def buildNet(numwords=NUMWORDS, maxlen=MAXLEN, embsize=EMBSIZE):
    return buildCNN(numwords, maxlen, embsize)


def main(epochs=15, datapath="testdata/"):
    runSentiment(buildNet, NUMWORDS, MAXLEN, epochs, datapath)


if __name__ == "__main__":
    main()
