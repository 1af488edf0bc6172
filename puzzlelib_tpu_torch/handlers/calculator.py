"""Batched inference handler (counterpart of
``puzzlelib_tpu/handlers/calculator.py``)."""

import numpy as np
import torch

from puzzlelib_tpu_torch.backend import gpuarray
from puzzlelib_tpu_torch.handlers.handler import Handler


class Calculator(Handler):
    def calcFromHost(self, data, macroBatchSize=10000, onMacroBatchFinish=None):
        """Run the module over host ``data`` in batches; returns host arrays.
        numpy has no bfloat16, so a bf16 module's outputs come back as
        float32 (which holds every bf16 value exactly)."""
        state = {"hostSize": self.getDataSize(data)}

        self.module.evalMode()
        self.handleFromHost(data, state, macroBatchSize, onMacroBatchFinish, random=False)

        return state["hostData"]

    def calc(self, data):
        """Run the module over device ``data`` in batches; returns tensors on
        the device, in the module's type."""
        state = {"devSize": self.getDataSize(data)}

        self.module.evalMode()
        self.handle(data, state, random=False)

        return state["devData"]

    def onMacroBatchStart(self, idx, macroBatchSize, state):
        # clamp to the actual extent of the final (possibly partial) macro-batch
        extent = macroBatchSize
        if "hostSize" in state:
            extent = min(extent, state["hostSize"] - idx * macroBatchSize)

        state["devSize"] = extent

    def onMacroBatchFinish(self, idx, macroBatchSize, state):
        if "hostData" not in state:
            def reserveHostData(data):
                return np.empty((state["hostSize"], ) + tuple(data.shape[1:]),
                                dtype=gpuarray.toNumpyDtype(data.dtype))

            state["hostData"] = self.parseShapeTree(state["devData"], onData=reserveHostData)

        def copyHostData(indata, outdata):
            start = idx * macroBatchSize
            outdata[start:start + indata.shape[0]] = gpuarray.get(indata)

        self.parseShapeTree(state["devData"], copyHostData, state["hostData"])
        del state["devData"]

    def handleBatch(self, batch, idx, state):
        self._storeBatch(self.module(batch), idx, state)

    def _storeBatch(self, outBatch, idx, state):
        if "devData" not in state:
            def reserveDevData(data):
                return torch.empty((state["devSize"], ) + tuple(data.shape[1:]), dtype=data.dtype,
                                   device=data.device)

            state["devData"] = self.parseShapeTree(outBatch, onData=reserveDevData)

        def copyDevData(indata, outdata):
            outdata[idx * self.batchsize:(idx + 1) * self.batchsize].copy_(indata)

        self.parseShapeTree(outBatch, copyDevData, state["devData"])
