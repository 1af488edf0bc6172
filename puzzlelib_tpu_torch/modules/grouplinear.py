"""Grouped linear layer (counterpart of ``puzzlelib_tpu/modules/grouplinear.py``):
an affine map per group over a 3-d tensor.

- ``batchDim`` 0: data (batch, groups, features); 1: (groups, batch,
  features).
- ``wmode`` "full": W (groups, rows, cols) and b (groups, out), one map a
  group; "one": one map, (1, rows, cols) and (1, out), shared by every
  group, its gradients summed over the groups.
- ``inmode`` "full": data with its groups; "one": data with one group,
  broadcast over the module's groups, its gradient summed back to one.
- ``transpW``: W stored as (groups, out, in).

The products are ``Blas.mulTensorBatch`` (``torch.matmul``), as the
reference's ``lax.dot_general`` with an f32 accumulator lies outside its
Pallas kernel; a group axis of 1 broadcasts.  f32 only, as in the reference.

Where the two packages part (ROADMAP Queue 3): the JAX package fails on
every combination but (batchDim 0, full, full), and (batchDim 1, full,
full) without a bias, and those without W; it checks a one-group input's
group count on axis 1 whatever ``batchDim`` is.  Here each combination
runs as the layout and the modes above say, the check reads the group
axis, and the bias gradient folds ``scale`` and ``momentum`` as W's does
(the reference writes the plain sum over it; the shared W's gradient
drops ``momentum`` there).
"""

from enum import Enum

from puzzlelib_tpu_torch.backend import blas as Blas
from puzzlelib_tpu_torch.variable import Variable
from puzzlelib_tpu_torch.modules.module import ModuleError, Module


class GroupMode(str, Enum):
    full = "full"
    one = "one"


# batchDim -> (mulTensorBatch layout tag, index of the group axis)
_LAYOUTS = {0: ("bgp", 1), 1: ("gbp", 0)}


class GroupLinear(Module):
    def __init__(self, groups, insize, outsize, wscale=1.0, useW=True, useBias=True, initscheme=None,
                 inmode="full", wmode="full", batchDim=0, name=None, empty=False, transpW=False):
        super().__init__(name)
        self.registerBlueprint(locals())

        if not useW and not useBias:
            raise ModuleError("Not using W and bias is not supported")

        try:
            self.format, self.groupDim = _LAYOUTS[batchDim]
        except KeyError:
            raise ModuleError("Unsupported batch dimension") from None

        self.useW, self.useBias, self.transpW = useW, useBias, transpW
        self.inmode, self.wmode = GroupMode(inmode), GroupMode(wmode)
        self.groups = groups if groups is not None else 1

        self.W = None
        self.b = None

        if empty:
            return

        wgroups = self.groups if self.wmode == GroupMode.full else 1

        if useW:
            rows, cols = (outsize, insize) if transpW else (insize, outsize)
            init = self.createTensorWithScheme(initscheme, (wgroups, rows, cols), wscale, factorShape=(rows, cols))
            self.setVar("W", Variable(self.paramTensor(init, (wgroups, rows, cols))))

        if useBias:
            bsize = outsize if useW else insize
            self.setVar("b", Variable(self.paramTensor(None, (wgroups, bsize)).zero_()))

    def _wFeatures(self):
        """(input features, output features) as the stored W defines them."""
        _, rows, cols = self.W.shape
        return (cols, rows) if self.transpW else (rows, cols)

    def _batchAxis(self):
        return 1 - self.groupDim

    def _foldGroups(self, t):
        """t summed over its group axis in f32, keeping the axis."""
        return t.float().sum(dim=self.groupDim, keepdim=True).to(t.dtype)

    def updateData(self, data):
        if self.useW:
            out = Blas.mulTensorBatch(data, self.W, formatA=self.format, formatB="gbp", transpB=self.transpW,
                                      formatOut=self.format)
        else:
            out = data.clone()

        if self.useBias:
            out = out + self.b.unsqueeze(self._batchAxis())

        self.data = out

    def updateGrad(self, grad):
        if self.useW:
            grad = Blas.mulTensorBatch(grad, self.W, formatA=self.format, formatB="gbp", transpB=not self.transpW,
                                       formatOut=self.format)

        self.grad = self._foldGroups(grad) if self.inmode == GroupMode.one else grad

    def accGradParams(self, grad, scale=1.0, momentum=0.0):
        shared = self.wmode == GroupMode.one

        if self.useW:
            A, B = (grad, self.inData) if self.transpW else (self.inData, grad)
            dw = Blas.mulTensorBatch(A, B, transpA=True, formatA=self.format, formatB=self.format, formatOut="gbp")
            if shared:
                dw = dw.float().sum(dim=0, keepdim=True).to(dw.dtype)

            self.foldParamGrad("W", dw, scale, momentum)

        if self.useBias:
            db = grad.float().sum(dim=self._batchAxis())
            if shared:
                db = db.sum(dim=0, keepdim=True)

            self.foldParamGrad("b", db.to(grad.dtype), scale, momentum)

    def _withGroupAxis(self, batch, g):
        return (batch, g) if self.groupDim == 1 else (g, batch)

    def dataShapeFrom(self, shape):
        batch = shape[self._batchAxis()]
        wgroups = (self.W if self.useW else self.b).shape[0]
        feat = self._wFeatures()[1] if self.useW else shape[2]
        return self._withGroupAxis(batch, max(shape[self.groupDim], wgroups)) + (feat, )

    def gradShapeFrom(self, shape):
        batch = shape[self._batchAxis()]
        g = self.groups if self.inmode == GroupMode.full else 1
        feat = self._wFeatures()[0] if self.useW else shape[2]
        return self._withGroupAxis(batch, g) + (feat, )

    def checkDataShape(self, shape):
        if len(shape) != 3:
            raise ModuleError("Data must be 3d tensor")

        g = shape[self.groupDim]
        if self.inmode == GroupMode.one:
            if g != 1:
                raise ModuleError("Expected 1 group in data, %d were given" % g)
        elif self.wmode != GroupMode.one and g != self.groups:
            raise ModuleError("Expected %d groups in data, %d were given" % (self.groups, g))

        if self.useW and shape[2] != self._wFeatures()[0]:
            raise ModuleError("Expected %d data dimensions, %d were given" % (self._wFeatures()[0], shape[2]))

    def checkGradShape(self, shape):
        if len(shape) != 3:
            raise ModuleError("Grad must be 3d tensor")

        g = shape[self.groupDim]
        if self.wmode == GroupMode.full and g != self.groups:
            raise ModuleError("Expected %d groups in grad, %d were given" % (self.groups, g))

        if self.useW and shape[2] != self._wFeatures()[1]:
            raise ModuleError("Expected %d grad dimensions, %d were given" % (self._wFeatures()[1], shape[2]))
