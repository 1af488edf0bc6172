"""SentiNet, the sentiment CNN over word embeddings (counterpart of
``puzzlelib_tpu/models/nets/sentinet.py``): an ``Embedder`` of the
vocabulary, the sentence as a one-map image (sentlength x embsize), one
branch per filter height, each a conv spanning the embedding
(``branchMaps`` maps of height ``fHeight``) and a max-pool over the
sentence (stride 2, the default, as in the reference), then ``Concat``,
relu, ``Dropout(0.5)`` and a ``Linear`` head of ``dim`` classes.

``onVocabulary`` zeroes row 0 of the embedding, the padding word, before it
looks at ``w2v``; with a ``w2v`` (a gensim-style model: ``vocab`` and item
lookup) it copies each word's vector, trying the part-of-speech suffixes in
the reference's order.  Dropout draws from the port's generator
(``rng.globalRng``).

Weights come from the init schemes or, through
``puzzlelib_tpu_torch.convert.paramsFromNumpy``, from a table of arrays,
or from the HDF5 checkpoint at ``modelpath``."""

import time

import numpy as np

from puzzlelib_tpu_torch.containers import Sequential, Parallel
from puzzlelib_tpu_torch.modules import (
    Embedder, Reshape, Replicate, Conv2D, MaxPool2D, Concat, Activation, relu, Dropout, Linear
)


def buildBranch(fHeight, sentlength, branchMaps, embsize):
    seq = Sequential()

    seq.append(Conv2D(1, outmaps=branchMaps, size=(fHeight, embsize)))
    seq.append(MaxPool2D(size=(sentlength - fHeight + 1, 1)))
    seq.append(Reshape((-1, branchMaps)))

    return seq


def buildNet(vocabulary, branches, w2v, sentlength, embsize, wscale, dim=2, branchMaps=100, name="sentinet"):
    def onVocabulary(W):
        W[0] = np.zeros((1, embsize), dtype=np.float32)

        arrayPOS = [
            "", "_S", "_A", "_V", "_UNKN", "_ADJ", "_ADV", "_INTJ", "_NOUN", "_PROPN", "_VERB", "_ADP",
            "_AUX", "_CCONJ", "_DET", "_NUM", "_PART", "_PRON", "_SCONJ", "_SUM", "_X"
        ]
        tmpPOS = []

        if not w2v:
            return

        for word in vocabulary:
            for pos in tmpPOS:
                if (word + pos) in w2v.vocab:
                    W[vocabulary[word]] = w2v[word + pos]
                    break

            for i, pos in enumerate(arrayPOS):
                if (word + pos) in w2v.vocab:
                    tmpPOS.append(pos)
                    W[vocabulary[word]] = w2v[word + pos]
                    del arrayPOS[i]
                    break

    net = Sequential(name)
    net.setAttr("timestamp", int(time.time()))

    net.append(Embedder(
        vocabulary, sentlength, embsize, wscale=wscale, onVocabulary=onVocabulary, learnable=True, name="embedder"
    ))
    net.append(Reshape((-1, 1, sentlength, embsize)))

    branchNum = len(branches)
    net.append(Replicate(times=branchNum))

    par = Parallel()
    for branchFilterSize in branches:
        par.append(buildBranch(branchFilterSize, sentlength, branchMaps, embsize))

    net.append(par)
    net.append(Concat(axis=1))

    net.append(Activation(relu))
    net.append(Dropout(p=0.5))
    net.append(Linear(branchNum * branchMaps, dim))

    return net


def loadSentiNet(modelpath, vocabulary, branches, sentlength, embsize, wscale=1.0, dim=2, branchMaps=100,
                 w2v=None, name="sentinet"):
    net = buildNet(vocabulary, branches, w2v, sentlength, embsize, wscale, dim, branchMaps, name)

    if modelpath is not None:
        net.load(modelpath)

    return net
