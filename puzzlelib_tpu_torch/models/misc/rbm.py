"""Restricted Boltzmann machine trained by contrastive divergence
(counterpart of ``puzzlelib_tpu/models/misc/rbm.py``).

``calcCDGrad`` / ``calcPCDGrad`` fill the variables' ``grad`` slots with the
*ascent* direction ``<v h>_data - <v h>_model``, so the usual optimizers,
which add the gradient, drive the log-likelihood up.  One Gibbs step
samples h | data, then v | h and h | v of the fantasy chain, which starts
from the data's own hidden sample (CD-1) or from the persistent
``particles`` (PCD).  Its products are ``torch.matmul``, as they are XLA
``dot``s in the JAX package: no kernel of the JAX package is on this path.

A stochastic unit fires where its sigmoid beats a uniform draw.  The draws
come from ``rng`` (``rng.globalRng`` by default), three ``fillUniform``
calls a step in the order h | data, v | h, h | v: ``seed(s)`` repeats them,
and a test gives both packages the same draws through a stand-in ``rng``.
The JAX package draws from ``jax.random`` keys instead.
"""

import math

import numpy as np
import torch

from puzzlelib_tpu_torch.backend import gpuarray
from puzzlelib_tpu_torch.modules.module import Module
from puzzlelib_tpu_torch.variable import Variable


class RBM(Module):
    def __init__(self, vsize, hsize, wscale=1.0, rng=None, useBias=True, name=None):
        super().__init__(name)

        if rng is None:
            from puzzlelib_tpu_torch.rng import globalRng
            rng = globalRng
        self.rng = rng

        scale = wscale / math.sqrt(vsize + hsize)
        W = np.random.normal(0.0, scale, (vsize, hsize)).astype(np.float32)
        self.W = None
        self.setVar("W", Variable(self.paramTensor(W, (vsize, hsize))))

        self.useBias = useBias
        if useBias:
            self.b, self.c = None, None
            self.setVar("b", Variable(self.paramTensor(None, (vsize, )).zero_()))
            self.setVar("c", Variable(self.paramTensor(None, (hsize, )).zero_()))

        self.particles = None

    # -- sampling -----------------------------------------------------------

    def _sample(self, preact):
        """Binary units: 1 where sigmoid(preact) beats a uniform draw."""
        u = torch.empty_like(preact)
        self.rng.fillUniform(u)
        return (u < torch.sigmoid(preact)).to(preact.dtype)

    def _hidden(self, visible):
        pre = visible @ self.W
        return self._sample(pre + self.c if self.useBias else pre)

    def _visible(self, hidden):
        pre = hidden @ self.W.T
        return self._sample(pre + self.b if self.useBias else pre)

    def hiddenFromVisible(self, visible):
        return self._hidden(visible)

    def visibleFromHidden(self, hidden):
        return self._visible(hidden)

    # -- training -----------------------------------------------------------

    def _accumulate(self, data, fantasy):
        """One Gibbs step's moment differences into the gradients; returns
        the chain's units (hData, vModel, hModel)."""
        hData = self._hidden(data)
        vModel = self._visible(hData if fantasy is None else fantasy)
        hModel = self._hidden(vModel)

        self.vars["W"].grad.copy_(data.T @ hData - vModel.T @ hModel)
        if self.useBias:
            self.vars["b"].grad.copy_(data.sum(dim=0) - vModel.sum(dim=0))
            self.vars["c"].grad.copy_(hData.sum(dim=0) - hModel.sum(dim=0))

        return hData, vModel, hModel

    def calcCDGrad(self, data):
        """CD-1: the fantasy chain starts from the data's own hidden sample.
        Returns the chain's units (hData, vModel, hModel)."""
        return self._accumulate(data, None)

    def calcPCDGrad(self, data):
        """Persistent CD: the fantasy chain goes on from ``particles``, made
        at the first call from the numpy sampler as in the JAX package.
        Returns the chain's units (hData, vModel, hModel)."""
        if self.particles is None:
            hsize = self.W.shape[1]
            init = np.random.binomial(1, 0.5, size=(data.shape[0], hsize))
            self.particles = gpuarray.to_gpu(init.astype(np.float32), dtype=self.W.dtype, device=data.device)

        units = self._accumulate(data, self.particles)
        self.particles = units[2]
        return units

    # -- module protocol (the reference RBM opts out of it too) -------------

    def updateData(self, data):
        raise RuntimeError("RBM does not support full module interface")

    def updateGrad(self, grad):
        raise RuntimeError("RBM does not support full module interface")

    def dataShapeFrom(self, shape):
        raise NotImplementedError()

    def gradShapeFrom(self, shape):
        raise NotImplementedError()
