"""Multi-head self-attention (counterpart of
``puzzlelib_tpu/modules/attention.py``).

The variables are the reference's: ``Wq Wk Wv Wo`` (emb, emb), drawn in that
order by the numpy sampler, and zero biases ``bq bk bv bo`` with
``useBias``.  ``attnAlgo`` (default ``Config.attentionAlgo``) picks the core:
"flash" is kernel K4 on CUDA tensors, "xla" the composed attention in
PyTorch, "auto" is resolved per input (``ops.attention.resolveAlgo``).  The
backward comes with the training slice.
"""

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.ops import attention as attnops
from puzzlelib_tpu_torch.variable import Variable
from puzzlelib_tpu_torch.modules.module import ModuleError, Module, backwardNotPorted


class MultiHeadAttention(Module):
    def __init__(self, embsize, nheads, causal=False, useBias=True, wscale=1.0, initscheme=None, attnAlgo=None,
                 name=None):
        super().__init__(name)

        if embsize % nheads != 0:
            raise ModuleError("Embedding size %d not divisible by %d heads" % (embsize, nheads))

        self.embsize = embsize
        self.nheads = nheads
        self.causal = causal
        self.useBias = useBias
        self.attnAlgo = attnAlgo if attnAlgo is not None else Config.attentionAlgo

        shape = (embsize, embsize)
        for wname in ("Wq", "Wk", "Wv", "Wo"):
            W = self.createTensorWithScheme(initscheme, shape, wscale, factorShape=shape)
            self.setVar(wname, Variable(self.paramTensor(W, shape)))

        if useBias:
            for bname in ("bq", "bk", "bv", "bo"):
                self.setVar(bname, Variable(self.paramTensor(None, (embsize, )).zero_()))

    def _algo(self, data):
        return attnops.resolveAlgo(self.attnAlgo, data.shape[1], data.dtype, data.device)

    def updateData(self, data):
        ws = [self.vars[n].data for n in ("Wq", "Wk", "Wv", "Wo")]
        bs = [self.vars[n].data for n in ("bq", "bk", "bv", "bo")] if self.useBias else [None] * 4

        self.data = attnops.mhaForward(data, *ws, *bs, nheads=self.nheads, causal=self.causal,
                                       algo=self._algo(data))

    def updateGrad(self, grad):
        raise backwardNotPorted(self)

    def accGradParams(self, grad, scale=1.0, momentum=0.0):
        raise backwardNotPorted(self)

    def checkDataShape(self, shape):
        if len(shape) != 3:
            raise ModuleError("Data must be 3d (batch, seq, emb)")
        if shape[2] != self.embsize:
            raise ModuleError("Expected embedding size %d, got %d" % (self.embsize, shape[2]))

    def dataShapeFrom(self, shape):
        return shape

    def calcMode(self, T):
        self.castVarsTo(self.requireSupportedDtype(T))
