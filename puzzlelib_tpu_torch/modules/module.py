"""Module base class: PuzzleLib's imperative layer protocol on ``nn.Module``.

Counterpart of ``puzzlelib_tpu/modules/module.py``.  A module is called with
its input (``__call__`` checks shape and dtype, then ``updateData`` sets
``self.data``), keeps its parameters as ``Variable``s in ``self.vars`` and has
train/eval/calc modes.  Being an ``nn.Module``, it registers each variable's
tensor as a parameter, so ``parameters()``, ``state_dict()`` and ``.to()``
work as usual.

``self.attrs`` holds the module's attributes: device tensors that are no
variable and that the module writes in place (a batch norm's running mean
and variance).  ``setAttr`` registers each as a buffer, so ``state_dict()``
and ``.to()`` see them too; the fused step walks them as state
(``fused.collectStateBuffers``) and ``convert`` moves them to and from
numpy.

Where the two protocols clash:

- The reference's ``Module.train`` is a bool attribute; ``nn.Module.train()``
  is a method.  The method stays, and the flag is ``nn.Module.training``:
  ``trainMode``/``evalMode`` set it on this module only (containers recurse
  themselves, as in the reference).
- ``nn.Module.__call__`` runs ``forward``; here ``__call__`` is PuzzleLib's,
  and ``forward`` calls it.

Weight init keeps the reference's numpy sampler (``createTensorWithScheme``),
so one ``np.random.seed`` gives both packages the same weights.

The backward protocol is the reference's: ``backward(grad)`` checks the
gradient, then ``updateGrad`` sets ``self.grad`` (the input gradient) and
``accGradParams`` folds the parameter gradients into the variables' ``grad``
buffers as ``grad * scale + buffer * momentum``.  Those writes, and every
other write to a variable (``zeroGradParams``, ``updateParams``), go in
place, so they reach variables that are views of an optimizer's flat
buffers.  Checkpoints and blueprints come with later parts of the port.
"""

import math
from enum import Enum

import numpy as np
import torch

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.backend import blas as Blas
from puzzlelib_tpu_torch.backend import gpuarray
from puzzlelib_tpu_torch.ops import elementwise as ew
from puzzlelib_tpu_torch.backend.device import getDevice
from puzzlelib_tpu_torch.variable import Variable


class ModuleError(Exception):
    pass


class InitScheme(str, Enum):
    none = "none"
    xavier = "xavier"
    xavierUniform = "xavier_uniform"
    xavierNormal = "xavier_normal"
    he = "he"
    gaussian = "gaussian"
    uniform = "uniform"


class FactorType(str, Enum):
    in_ = "in"
    out = "out"
    avg = "avg"


def _mapNested(fn, data):
    """Apply ``fn`` to every leaf of a (possibly nested) list/tuple of tensors."""
    if isinstance(data, (tuple, list)):
        return [_mapNested(fn, item) for item in data]

    return fn(data)


class Module(torch.nn.Module):
    def __init__(self, name=None):
        super().__init__()
        self.name = name

        self.vars = {}
        self.attrs = {}

        # dataflow hints consumed by containers
        self.gradUsesOutData = False
        self.movesData = False
        self.movesGrad = False

        self.inData, self.data, self.grad = None, None, None

        self.training = not Config.globalEvalMode
        self.calctype = torch.float32

    # -- variable registry -------------------------------------------------------

    def setVar(self, name, var):
        setattr(self, name, var.data)
        self.vars[name] = var

    def getVar(self, name):
        return self.vars[name]

    def getVarTable(self, vartable=None, name=None, root=True):
        if root and name is None:
            name = self.name or ""

        if vartable is None:
            vartable = {}

        for paramName, var in self.vars.items():
            vartable.setdefault(var, []).append("%s%s" % (name, paramName))

        return vartable

    def setAttr(self, name, attr):
        """Register the tensor ``attr`` as the attribute ``name``: a buffer
        of the ``nn.Module``, which the module writes in place only."""
        self.__dict__.pop(name, None)
        self.register_buffer(name, attr)
        self.attrs[name] = attr

    def hasAttr(self, name):
        return name in self.attrs

    def getAttrTable(self, attrtable=None, name=None, root=True):
        """The attributes of the tree by name, as ``getVarTable`` names a
        variable: ``"<module path>.<attr>"`` inside a container, the
        reference's checkpoint names."""
        if root and name is None:
            name = self.name or ""

        if attrtable is None:
            attrtable = {}

        for attrName, attr in self.attrs.items():
            attrtable["%s%s" % (name, attrName)] = attr

        return attrtable

    def node(self, *nodes):
        """A ``containers.Node`` of this module, wired after ``nodes``, for a
        ``Graph``."""
        from puzzlelib_tpu_torch.containers.node import Node
        return Node(self, parents=list(nodes) if nodes else None)

    # -- forward protocol ----------------------------------------------------------

    def __call__(self, data):
        if not Config.disableDtypeShapeChecks:
            self.checkDataShape(self.acquireShapesFrom(data))
            self.checkDataType(self.acquireDtypesFrom(data))

        self.data, self.inData = None, data
        self.updateData(data)

        return self.data

    def forward(self, data):
        return self(data)

    def updateData(self, data):
        raise NotImplementedError()

    def backward(self, grad, updParamGrads=True, updGrad=True, scale=1.0, momentum=0.0):
        if not Config.disableDtypeShapeChecks:
            self.checkGradShape(self.acquireShapesFrom(grad))
            self.checkGradType(self.acquireDtypesFrom(grad))

        self.grad = None

        if updGrad:
            self.updateGrad(grad)

        if updParamGrads and self.training:
            self.accGradParams(grad, scale=scale, momentum=momentum)

    def updateGrad(self, grad):
        raise NotImplementedError()

    def accGradParams(self, grad, scale=1.0, momentum=0.0):
        pass

    def writeOver(self, target, result):
        """``result``, written over ``target`` where the module is inplace and
        ``target`` is no view of another tensor (a ``Concat`` backward's
        split, a slice): an inplace module never writes through a view it
        does not own."""
        return target.copy_(result) if self.inplace and target._base is None else result

    def foldParamGrad(self, name, newGrad, scale=1.0, momentum=0.0):
        """vars[name].grad = scale * newGrad + momentum * vars[name].grad, in
        place."""
        acc = self.vars[name].grad
        ew.add_(acc, newGrad.reshape(acc.shape), scale, acc, momentum)

    def zeroGradParams(self):
        for var in self.vars.values():
            if not var.hasUpdater:
                var.grad.zero_()

    def updateParams(self, learnRate):
        for var in self.vars.values():
            Blas.toVectorAddVector(var.data.view(-1), var.grad.view(-1), alpha=learnRate)

    # -- modes -------------------------------------------------------------------------

    def trainMode(self):
        self.training = True
        self.reset()

    def evalMode(self):
        self.training = False
        self.reset()

    def calcMode(self, T):
        if gpuarray.toTorchDtype(T) != torch.float32:
            raise ModuleError("Unsupported dtype %s" % T)

        self.calctype = torch.float32

    def reset(self):
        self.inData, self.data, self.grad = None, None, None

    # -- shape / dtype validation ----------------------------------------------------

    def checkDataShape(self, shape):
        pass

    def checkGradShape(self, shape):
        pass

    def dataShapeFrom(self, shape):
        raise NotImplementedError()

    def gradShapeFrom(self, shape):
        raise NotImplementedError()

    def checkDataType(self, dtype):
        self.genericCheckDataType(dtype)

    def checkGradType(self, dtype):
        self.genericCheckDataType(dtype)

    def genericCheckDataType(self, dtype):
        mismatched = []
        _mapNested(lambda d: mismatched.append(d) if d != self.calctype else None, dtype)

        if mismatched:
            raise ModuleError("Expected dtype %s, got %s" % (self.calctype, mismatched[0]))

    @classmethod
    def acquireShapesFrom(cls, data):
        return _mapNested(lambda d: tuple(d.shape), data)

    @classmethod
    def acquireDtypesFrom(cls, data):
        return _mapNested(lambda d: d.dtype, data)

    # -- introspection -------------------------------------------------------------------

    def numOfParams(self):
        return sum(var.data.numel() for var in self.vars.values())

    def __str__(self):
        return "Module %s (name: %s)" % (type(self).__name__, self.name)

    # -- helpers ---------------------------------------------------------------------------

    def castVarsTo(self, T):
        """Recreate all vars in dtype T (the shared calcMode of parametric
        modules)."""
        if self.calctype == T:
            return

        variables = self.vars
        self.vars = {}

        for varName, var in variables.items():
            grad = var.grad.to(T) if var.grad is not None else None
            self.setVar(varName, Variable(var.data.detach().to(T), name=var.name, grad=grad))

        self.calctype = T

    @staticmethod
    def requireSupportedDtype(T):
        T = gpuarray.toTorchDtype(T)

        if T not in {dtype for dtype, _ in gpuarray.dtypesSupported()}:
            raise ModuleError("Unsupported dtype %s" % T)

        return T

    def supportedDtypesCalcMode(self, T):
        self.calctype = self.requireSupportedDtype(T)

    @staticmethod
    def repeat(val, ntimes):
        return (val, ) * ntimes if isinstance(val, int) else tuple(val)

    # -- parameter initialization ------------------------------------------------------------

    def paramTensor(self, init, shape):
        """A parameter tensor on the configured device in the module's type:
        ``init`` (a host array from ``createTensorWithScheme``), or uninitialised
        memory when the scheme is "none"."""
        if init is None:
            return torch.empty(shape, dtype=self.calctype, device=getDevice())

        return gpuarray.to_gpu(init, dtype=self.calctype)

    @staticmethod
    def inferNeuronsNumber(shape, transpose):
        """Fan-out / fan-in pair of a parameter tensor shape."""
        if len(shape) == 1:
            fanOut = fanIn = shape[0]
        elif len(shape) == 2:
            fanIn, fanOut = shape
        else:
            field = int(np.prod(shape[2:]))
            fanOut, fanIn = shape[0] * field, shape[1] * field

        return (fanIn, fanOut) if transpose else (fanOut, fanIn)

    @staticmethod
    def createTensorWithScheme(scheme, shape, wscale, factorShape=None, factorTranspose=False, dtype=np.float32):
        """The reference's numpy sampler, draw for draw: a host array, or None
        for the "none" scheme."""
        factorType = FactorType.in_

        if isinstance(scheme, (tuple, list)):
            if len(scheme) != 2:
                raise ValueError("Scheme tuple has %s length, expected 2" % len(scheme))

            scheme, factorType = scheme

        scheme = None if scheme is None else InitScheme(scheme)

        outs, ins = Module.inferNeuronsNumber(shape if factorShape is None else factorShape, factorTranspose)
        factor = {
            FactorType.in_: ins,
            FactorType.out: outs,
            FactorType.avg: (outs + ins) / 2,
        }[FactorType(factorType)]

        # each scheme maps to (sampler, scale); None defaults to xavier-uniform
        samplers = {
            None: ("uniform", math.sqrt(3.0 / factor)),
            InitScheme.xavierUniform: ("uniform", math.sqrt(3.0 / factor)),
            InitScheme.xavier: ("normal", math.sqrt(1.0 / factor)),
            InitScheme.xavierNormal: ("normal", math.sqrt(1.0 / factor)),
            InitScheme.he: ("normal", math.sqrt(2.0 / factor)),
            InitScheme.gaussian: ("normal", wscale),
            InitScheme.uniform: ("uniform", wscale),
        }

        if scheme == InitScheme.none:
            return None

        kind, width = samplers[scheme]
        if kind == "uniform":
            tensor = np.random.uniform(-width, width, shape)
        else:
            tensor = np.random.normal(0.0, width, shape)

        return tensor.astype(dtype)
