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
buffers.

Each module records its constructor's arguments (``registerBlueprint``), so
``getBlueprint()`` describes it as the JAX package does and
``blueprint.BlueprintFactory`` rebuilds it.  ``save`` and ``load`` write and
read the JAX package's HDF5 layout (``puzzlelib_tpu_torch.hdf``); a load
writes each value into the variable's or attribute's own tensor, in place,
so variables that are views of an optimizer's flat buffers stay views and
a fused step's recorded graphs keep their addresses.
"""

import math
import warnings
from enum import Enum

import numpy as np
import torch

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch import hdf as hdfcodec
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


def loadInto(target, value):
    """Write a value read from a checkpoint (a host array, or a bf16 CPU
    tensor) into the tensor ``target`` on its device, in place, under
    numpy's ``casting="safe"``: an f32 file into a bf16 net raises, bf16
    into f32 loads."""
    src, dst = hdfcodec.dtypeName(value), hdfcodec.dtypeName(target)

    if not hdfcodec.canCastSafely(src, dst):
        raise TypeError("Cannot cast array data from dtype('%s') to dtype('%s') according to the rule 'safe'" %
                        (src, dst))

    if tuple(value.shape) != tuple(target.shape):
        raise ValueError("shape %s in the file, %s in the module" % (tuple(value.shape), tuple(target.shape)))

    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(value if value.flags.writeable else value.copy())

    with torch.no_grad():
        target.copy_(value)


def hostValue(value):
    """A host value read from a checkpoint as a module keeps it: a scalar
    for a 0-d array, else the array."""
    return value.item() if isinstance(value, np.ndarray) and value.ndim == 0 else value


class Module(torch.nn.Module):
    # subclasses raising container-flavored errors override these two
    _errorKind = "Module"
    _errorType = ModuleError

    def __init__(self, name=None):
        super().__init__()
        self.name = name

        self.blueprint = None
        self.registerBlueprint(locals())

        self.vars = {}
        self.attrs = {}
        self.hostAttrs = {}

        # dataflow hints consumed by containers
        self.gradUsesOutData = False
        self.movesData = False
        self.movesGrad = False

        self.inData, self.data, self.grad = None, None, None

        self.training = not Config.globalEvalMode
        self.calctype = torch.float32

        # optional checkpoint interception hooks: (name, value read from the file)
        self.varLoader = None
        self.attrLoader = None

    # -- blueprint / variable registry ----------------------------------------------

    def registerBlueprint(self, args, exclude=None):
        """Record the constructor's arguments (its ``locals()``) as the
        module's scheme; the names in ``exclude`` are recorded as None."""
        hidden = {"self", "__class__"}
        masked = set() if exclude is None else set(exclude)

        self.blueprint = {
            key: (None if key in masked else value)
            for key, value in args.items() if key not in hidden
        }

    def getBlueprint(self):
        return {"classname": type(self).__name__, "scheme": self.blueprint}

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
        of the ``nn.Module``, which the module writes in place only.  A host
        value (a net's timestamp, a preset's sentence length) is kept as a
        plain attribute in ``hostAttrs``, as the reference keeps it."""
        if not isinstance(attr, torch.Tensor):
            setattr(self, name, attr)
            self.hostAttrs[name] = attr
            return

        self.__dict__.pop(name, None)
        self.register_buffer(name, attr)
        self.attrs[name] = attr

    def hasAttr(self, name):
        return name in self.attrs or name in self.hostAttrs

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

    def optimizeForShape(self, shape, memlimit=None):
        """The reference's per-shape algorithm search: nothing to search
        for a module without one (``ConvND`` times its convs)."""

    # -- persistence -------------------------------------------------------------------

    def _checkpointPath(self, name, assumeUniqueNames):
        """Dotted path of this module inside the checkpoint namespace."""
        if name is None:
            name = self.name or ""

        if assumeUniqueNames and name:
            # collapse the middle of the path: root + leaf identify the module
            pieces = name.split(".")
            name = "%s.%s" % (pieces[0], pieces[-1])

        return name

    def _failPersist(self, verb, name, exc):
        raise self._errorType("%s %s %s error: %s" % (self._errorKind, name, verb, exc)) from exc

    def _writeState(self, hdf, varlinks, name, compress, assumeUniqueNames=False):
        """Leaf persistence: deduplicated vars + flat attribute datasets."""
        for paramName, var in self.vars.items():
            hdfcodec.storeParam(hdf, "%s.%s" % (name, paramName), var, varlinks, compress)

        hdfcodec.storeAttrs(
            hdf, {"%s.%s" % (name, attrName): attr for attrName, attr in {**self.attrs, **self.hostAttrs}.items()},
            compress=compress,
        )

    def _readState(self, hdf, initvars, name, assumeUniqueNames):
        for paramName, var in self.vars.items():
            if var in initvars:
                continue  # shared variable already restored through another link

            param = hdfcodec.fetchParam(hdf, "%s.%s" % (name, paramName))

            if self.varLoader is not None:
                self.varLoader(paramName, param)
            else:
                loadInto(var.data, param)

            initvars[var] = True

        for attrName, attr in {**self.attrs, **self.hostAttrs}.items():
            value = hdfcodec.fetchAttr(hdf, "%s.%s" % (name, attrName))

            if self.attrLoader is not None:
                self.attrLoader(attrName, value)
            elif isinstance(attr, torch.Tensor):
                loadInto(attr, value)
            else:
                self.setAttr(attrName, hostValue(value))

    def save(self, hdf=None, varlinks=None, name=None, compress="gzip", assumeUniqueNames=False,
             withBlueprint=False, isRoot=True):
        """Write the module's variables and attributes into ``hdf`` (a path,
        an open handle, or nothing: then the file's image comes back as
        bytes), with its blueprint if ``withBlueprint``."""
        wantImage = hdf is None
        hdf, owned = hdfcodec.openStore(hdf, "w")

        name = self._checkpointPath(name, assumeUniqueNames)
        varlinks = {} if varlinks is None else varlinks

        image = None
        try:
            self._writeState(hdf, varlinks, name, compress, assumeUniqueNames)

            if withBlueprint:
                hdfcodec.storeBlueprint(hdf, self.getBlueprint())

            if isRoot and wantImage:
                image = hdfcodec.snapshot(hdf)

        except Exception as e:
            self._failPersist("save", name, e)

        finally:
            if isRoot and owned:
                hdf.close()

        return image

    def load(self, hdf, initvars=None, name=None, assumeUniqueNames=False, isRoot=True):
        """Read the module's variables and attributes from ``hdf`` (a path, a
        file image or an open handle), each into its own tensor, in place;
        a value that does not cast safely to the tensor's type raises."""
        hdf, owned = hdfcodec.openStore(hdf, "r")

        name = self._checkpointPath(name, assumeUniqueNames)
        initvars = {} if initvars is None else initvars

        with warnings.catch_warnings():
            warnings.filterwarnings("error")

            try:
                self._readState(hdf, initvars, name, assumeUniqueNames)

            except Exception as e:
                self._failPersist("load", name, e)

            finally:
                if isRoot and owned:
                    hdf.close()

    @staticmethod
    def ensureHdf(file, mode):
        store, _ = hdfcodec.openStore(file, mode)
        return store

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
