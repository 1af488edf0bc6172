"""Batching engine (counterpart of ``puzzlelib_tpu/handlers/handler.py``).

``handleFromHost`` slices host arrays into macro-batches and uploads each to
the configured device in one transfer, then ``handle`` walks the
mini-batches of the resident macro-batch.  With ``random`` (the Trainer's
default) both walks go in a shuffled order drawn from
``np.random.permutation``, as in the reference, so one numpy seed gives both
packages the same order; without it (the Calculator) they go in order.
numpy has no bfloat16, so for a module in bf16 (``calcMode(torch.bfloat16)``)
float32 host data is uploaded as float32 and cast to bf16 on the device;
data of other types (the int32 labels) is uploaded as it is.
"""

import numpy as np
import torch

from puzzlelib_tpu_torch.backend import gpuarray


class Handler:
    def __init__(self, mod, onBatchFinish=None, batchsize=128):
        self.module = mod

        self.batchsize = batchsize
        self.onBatchFinish = onBatchFinish

        self.currBatch, self.totalBatches = 0, 0
        self.currMacroBatch, self.totalMacroBatches = 0, 0

    # -- tiling helpers ----------------------------------------------------------

    @staticmethod
    def _tileCount(datasize, tilesize):
        return -(-datasize // tilesize)

    @staticmethod
    def _tileOrder(count, shuffled):
        return np.random.permutation(count) if shuffled else np.arange(count)

    @staticmethod
    def getDataSize(data):
        head = data
        while isinstance(head, list):
            head = head[0]

        return head.shape[0]

    @classmethod
    def sliceData(cls, data, idx, batchsize, postSlice):
        if isinstance(data, list):
            return [cls.sliceData(item, idx, batchsize, postSlice) for item in data]

        start = idx * batchsize
        return postSlice(data[start:start + batchsize])

    @classmethod
    def parseShapeTree(cls, data, onData, auxdata=None):
        if not isinstance(data, list):
            return onData(data, auxdata) if auxdata is not None else onData(data)

        aux = [None] * len(data) if auxdata is None else auxdata
        return [cls.parseShapeTree(item, onData, a) for item, a in zip(data, aux)]

    def upload(self, ary):
        """A host slice on the device; float32 goes to bf16 for a bf16 module."""
        bf16 = ary.dtype == np.float32 and self.module.calctype == torch.bfloat16
        return gpuarray.to_gpu(ary, dtype=torch.bfloat16 if bf16 else None)

    # -- staging loops --------------------------------------------------------------

    def handleFromHost(self, data, state=None, macroBatchSize=10000, onMacroBatchFinish=None, random=True):
        self.totalMacroBatches = self._tileCount(self.getDataSize(data), macroBatchSize)

        for ordinal, n in enumerate(self._tileOrder(self.totalMacroBatches, random), start=1):
            staged = self.sliceData(data, n, macroBatchSize, postSlice=self.upload)
            self.currMacroBatch = ordinal

            self.onMacroBatchStart(n, macroBatchSize, state)
            self.handle(staged, state, random=random)
            self.onMacroBatchFinish(n, macroBatchSize, state)

            if onMacroBatchFinish is not None:
                onMacroBatchFinish(self)

    def handle(self, data, state=None, random=True):
        self.totalBatches = self._tileCount(self.getDataSize(data), self.batchsize)

        for ordinal, n in enumerate(self._tileOrder(self.totalBatches, random), start=1):
            batch = self.sliceData(data, n, self.batchsize, postSlice=lambda view: view)
            self.currBatch = ordinal

            self.handleBatch(batch, n, state)
            self.module.reset()

            if self.onBatchFinish is not None:
                self.onBatchFinish(self)

    # -- subclass surface --------------------------------------------------------------

    def onMacroBatchStart(self, idx, macroBatchSize, state):
        pass

    def onMacroBatchFinish(self, idx, macroBatchSize, state):
        pass

    def handleBatch(self, batch, idx, state):
        raise NotImplementedError()
