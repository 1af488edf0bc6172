"""Word embedding (counterpart of ``puzzlelib_tpu/modules/embedder.py``).

Gathers rows of W by int32 token index; a negative index is padding and
gives a zero row.  The vocabulary is kept as a host array of words
(``vocab``), as the reference keeps it.  The backward is a scatter-add into
W's gradient (``ops.embed.embedBackwardParams``); tokens have no gradient, so
``updateGrad`` sets none.

A checkpoint may hold another vocabulary than the module's: its loading
hooks (``varLoader`` / ``attrLoader``) take the file's ``W`` and ``vocab``
whatever their vocabulary size, as the reference's do.  That makes ``W``
anew, a new tensor, not a write in place: load such a file before an
optimizer's ``setupOn``, which would otherwise keep the old ``W``.
"""

import numpy as np
import torch

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.variable import Variable
from puzzlelib_tpu_torch.modules.module import ModuleError, Module
from puzzlelib_tpu_torch.ops.embed import embed, embedBackwardParams


def _vocabArray(vocabulary):
    """Normalize the ctor vocabulary argument to (size, array of words)."""
    if isinstance(vocabulary, int):
        return vocabulary, np.empty((0, ), dtype=object)

    if isinstance(vocabulary, dict):
        words = np.empty((len(vocabulary), ), dtype=object)
        for word, idx in vocabulary.items():
            words[int(idx)] = word

        return len(vocabulary), words

    raise ModuleError("Unrecognized vocabulary parameter type")


class Embedder(Module):
    def __init__(self, vocabulary, sentlength, embsize, onVocabulary=None, initscheme="uniform", wscale=1.0,
                 learnable=True, name=None):
        super().__init__(name)
        ctorArgs = dict(locals())

        self.embsize, self.sentlength = embsize, sentlength
        self.learnable = learnable
        self.outgrad = None

        vocabsize, words = _vocabArray(vocabulary)

        self.vocab = None
        self.setAttr("vocab", words)

        ctorArgs["vocabulary"] = vocabsize
        self.registerBlueprint(ctorArgs, exclude=["onVocabulary"])

        W = self.createTensorWithScheme(initscheme, (vocabsize, embsize), wscale, (embsize, vocabsize))
        if onVocabulary is not None:
            W = np.empty((vocabsize, embsize), dtype=np.float32) if W is None else W
            onVocabulary(W)

        self.W = None
        self.setVar("W", Variable(self.paramTensor(W, (vocabsize, embsize))))

        self.varLoader = self.checkVarOnLoad
        self.attrLoader = self.checkAttrOnLoad

    # -- checkpoint hooks (embedding tables may change vocab size on load) -------

    def checkVarOnLoad(self, paramName, dataset):
        if paramName != "W":
            raise ModuleError("Unknown parameter name '%s' for embedder" % paramName)

        if dataset.shape[1] != self.embsize:
            raise ModuleError("Expected embedding size %s, was given %s" % (self.embsize, dataset.shape[1]))

        value = dataset if isinstance(dataset, torch.Tensor) else torch.from_numpy(np.array(dataset))
        self.setVar("W", Variable(value.to(self.W.device)))

    def checkAttrOnLoad(self, attrName, dataset):
        if attrName != "vocab":
            raise ModuleError("Unknown attribute name '%s' for embedder" % attrName)

        self.setAttr("vocab", dataset)

    def getVocabulary(self):
        if not self.hasAttr("vocab"):
            return {}

        return {word: index for index, word in enumerate(self.vocab)}

    def verifyData(self, data):
        lo = int(data.min())
        if lo < -1:
            raise ModuleError("Embedder data verification failed, found index %s (< -1)" % lo)

        hi = int(data.max())
        if hi >= self.W.shape[0]:
            raise ModuleError("Embedder data verification failed, found index %s (vocabulary size is %s)" %
                              (hi, self.W.shape[0]))

    def updateData(self, data):
        if Config.verifyData:
            self.verifyData(data)

        self.data = embed(data, self.W)

    def updateGrad(self, grad):
        self.grad = None   # tokens are not differentiable

    def accGradParams(self, grad, scale=1.0, momentum=0.0):
        # the reference zeroes W's gradient whatever momentum says
        self.outgrad = grad
        self.vars["W"].grad.zero_()

        if self.learnable:
            embedBackwardParams(self.inData, grad, self.vars["W"].grad, scale)

    def updateParams(self, learnRate):
        if self.learnable:
            embedBackwardParams(self.inData, self.outgrad, self.vars["W"].data, learnRate)

    def dataShapeFrom(self, shape):
        return shape[0], shape[1], self.embsize

    def gradShapeFrom(self, shape):
        raise ModuleError("Gradient propagation is undefined")

    def checkDataShape(self, shape):
        if len(shape) != 2:
            raise ModuleError("Data must be 2d matrix")

        if shape[1] != self.sentlength:
            raise ModuleError("Expected %d data sentence length, %d was given" % (self.sentlength, shape[1]))

    def checkGradShape(self, shape):
        if len(shape) != 3:
            raise ModuleError("Grad must be 3d tensor")

        expectations = (
            (shape[1], self.sentlength, "Expected %d grad sentence length, %d was given"),
            (shape[2], self.embsize, "Expected %d grad embedding size, %d was given"),
            (shape[0], self.inData.shape[0], "Expected %d grad batch size, %d was given"),
        )
        for given, expected, message in expectations:
            if given != expected:
                raise ModuleError(message % (expected, given))

    def checkDataType(self, dtype):
        if dtype != torch.int32:
            raise ModuleError("Expected int32-tensor (got dtype %s)" % dtype)

    def reset(self):
        super().reset()
        self.outgrad = None

    def calcMode(self, T):
        self.castVarsTo(self.requireSupportedDtype(T))
