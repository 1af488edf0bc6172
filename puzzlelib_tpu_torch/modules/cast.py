"""Type conversion between float32, float16 and bfloat16 (counterpart of
``puzzlelib_tpu/modules/cast.py``): the forward casts to ``outtype``, the
backward the gradient back to ``intype``; with equal types both pass the
tensor through.  The module checks its input's type against ``intype`` and
its gradient's against ``outtype``, whatever the net's ``calcMode``, as the
reference does; it is appended after a net's ``calcMode`` (a bf16 net's
trailing cast to f32)."""

from enum import Enum

import torch

from puzzlelib_tpu_torch.backend import gpuarray
from puzzlelib_tpu_torch.modules.module import ModuleError, Module


class DataType(str, Enum):
    float32 = "float32"
    float16 = "float16"
    bfloat16 = "bfloat16"


_TORCH = {DataType.float32: torch.float32, DataType.float16: torch.float16, DataType.bfloat16: torch.bfloat16}


class Cast(Module):
    def __init__(self, intype, outtype, name=None):
        super().__init__(name)

        intype, outtype = self.dataTypeToNumpy(intype), self.dataTypeToNumpy(outtype)
        self.registerBlueprint(locals())

        self.intype, self.outtype = intype, outtype

    def updateData(self, data):
        self.data = data.to(_TORCH[self.outtype]) if self.intype != self.outtype else data

    def updateGrad(self, grad):
        self.grad = grad.to(_TORCH[self.intype]) if self.intype != self.outtype else grad

    def dataShapeFrom(self, shape):
        return shape

    def gradShapeFrom(self, shape):
        return shape

    def checkDataType(self, dtype):
        if dtype != _TORCH[self.intype]:
            raise ModuleError("Expected dtype %s, got %s" % (self.intype.value, dtype))

    def checkGradType(self, dtype):
        if dtype != _TORCH[self.outtype]:
            raise ModuleError("Expected dtype %s, got %s" % (self.outtype.value, dtype))

    @staticmethod
    def dataTypeToNumpy(T):
        """The ``DataType`` of a name, a numpy or torch type or a
        ``DataType``."""
        if isinstance(T, DataType):
            return T

        if isinstance(T, str):
            return DataType(T)

        return DataType(str(gpuarray.toTorchDtype(T)).replace("torch.", ""))
