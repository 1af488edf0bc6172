"""Multi-head self-attention (counterpart of
``puzzlelib_tpu/modules/attention.py``).

The variables are the reference's: ``Wq Wk Wv Wo`` (emb, emb), drawn in that
order by the numpy sampler, and zero biases ``bq bk bv bo`` with
``useBias``.  ``attnAlgo`` (default ``Config.attentionAlgo``) picks the core:
"flash" is kernel K4 on CUDA tensors, "xla" the composed attention in
PyTorch, "auto" is resolved per input (``ops.attention.resolveAlgo``): the
choice that ``optimizeForShape`` measured for the signature, else the
structural prior.

In training the forward keeps what the backward needs (``mhaForward``'s
saved state: the projected heads, the core's output and lse), and
``updateGrad`` and ``accGradParams`` share one backward per (forward,
gradient, core) triple, as the reference's ``_vjp`` cache shares one per
(forward, gradient): under "flash" that is one launch each of K5a and K5b
and no second launch of K4.  The core of the backward is resolved when it
runs, so a net whose ``attnAlgo`` is changed between the forward and the
backward runs the new core's backward on the same saved forward.
"""

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.ops import attention as attnops
from puzzlelib_tpu_torch.variable import Variable
from puzzlelib_tpu_torch.modules.module import ModuleError, Module


class MultiHeadAttention(Module):
    def __init__(self, embsize, nheads, causal=False, useBias=True, wscale=1.0, initscheme=None, attnAlgo=None,
                 name=None):
        super().__init__(name)
        self.registerBlueprint(locals())

        if embsize % nheads != 0:
            raise ModuleError("Embedding size %d not divisible by %d heads" % (embsize, nheads))

        self.embsize = embsize
        self.nheads = nheads
        self.causal = causal
        self.useBias = useBias
        self.attnAlgo = attnAlgo if attnAlgo is not None else Config.attentionAlgo
        self._saved, self._bwd = None, None

        shape = (embsize, embsize)
        for wname in ("Wq", "Wk", "Wv", "Wo"):
            W = self.createTensorWithScheme(initscheme, shape, wscale, factorShape=shape)
            self.setVar(wname, Variable(self.paramTensor(W, shape)))

        if useBias:
            for bname in ("bq", "bk", "bv", "bo"):
                self.setVar(bname, Variable(self.paramTensor(None, (embsize, )).zero_()))

    def _algo(self, data):
        return attnops.resolveAlgo(self.attnAlgo, data.shape[0], self.nheads, data.shape[1],
                                   self.embsize // self.nheads, self.causal, data.dtype, data.device)

    def optimizeForShape(self, shape, memlimit=None):
        """Race the flash kernels against the composed attention at this
        layer's signature and record the faster (the reference's cuDNN
        algo-search hook); nothing on the CPU."""
        attnops.measureAttnChoice(shape[0], self.nheads, shape[1], self.embsize // self.nheads, self.causal,
                                  self.calctype)

    def _weights(self):
        ws = [self.vars[n].data for n in ("Wq", "Wk", "Wv", "Wo")]
        bs = [self.vars[n].data for n in ("bq", "bk", "bv", "bo")] if self.useBias else [None] * 4
        return ws, bs

    def updateData(self, data):
        ws, bs = self._weights()
        self.data, self._saved = attnops.mhaForward(data, *ws, *bs, nheads=self.nheads, causal=self.causal,
                                                    algo=self._algo(data), save=True)
        if not self.training:
            self._saved = None   # a serving net keeps nothing for a backward

        # any cached backward belongs to the previous forward
        self._bwd = None

    def _backward(self, grad):
        """The cached ``mhaBackward`` of the last forward for ``grad`` (held
        strongly, so its identity cannot be recycled) under the current
        core; a new gradient or core recomputes."""
        algo = self._algo(self.inData)
        if self._bwd is None or self._bwd[0] is not grad or self._bwd[1] != algo:
            ws, bs = self._weights()
            grads = attnops.mhaBackward(self.inData, *ws, *bs, grad, nheads=self.nheads, causal=self.causal,
                                        algo=algo, saved=self._saved)
            self._bwd = (grad, algo, grads)

        return self._bwd[2]

    def updateGrad(self, grad):
        self.grad = self._backward(grad)[0]

    def accGradParams(self, grad, scale=1.0, momentum=0.0):
        names = ("Wq", "Wk", "Wv", "Wo") + (("bq", "bk", "bv", "bo") if self.useBias else ())
        for name, g in zip(names, self._backward(grad)[1:]):
            self.foldParamGrad(name, g, scale, momentum)

    def reset(self):
        super().reset()
        self._saved, self._bwd = None, None

    def checkDataShape(self, shape):
        if len(shape) != 3:
            raise ModuleError("Data must be 3d (batch, seq, emb)")
        if shape[2] != self.embsize:
            raise ModuleError("Expected embedding size %d, got %d" % (self.embsize, shape[2]))

    def checkGradShape(self, shape):
        self.checkDataShape(shape)

    def dataShapeFrom(self, shape):
        return shape

    def gradShapeFrom(self, shape):
        return shape

    def calcMode(self, T):
        self.castVarsTo(self.requireSupportedDtype(T))
