"""Optimizer base (counterpart of ``puzzlelib_tpu/optimizers/optimizer.py``).

Local state keeps one state per variable.  Global state
(``setupOn(net, useGlobalState=True)``) packs every parameter, and every
gradient, of a dtype into one flat tensor (``gpuarray.SharedArray``) and
rebinds the net's variables as views of it, so one update per dtype covers
every parameter.  The views are the variables from then on: every write to
them goes in place, and ``calcMode``, which rebuilds the variables, must come
before ``setupOn``, as in the reference.

Hooks run on each (variable, state) before its update.  ``save`` and
``load`` write and read the JAX package's HDF5 layout: the groups
``<prefix>.attrs`` (``t``, ``learnRate`` and the optimizer's own rates) and
``<prefix>.states``, whose datasets are ``<state>.<entity>``, a state named
by its variable under local state and by the numpy type of its flat buffer
under global state (``"<class 'numpy.float32'>.mom"``).  A load writes each
state tensor in place, so a fused step's recorded graphs keep reading it.
The state also moves to and from numpy through
``convert.optimizerStateToNumpy`` / ``optimizerStateFromNumpy``.

With a ``nodeinfo`` (a grid node, ``parallel/grid.py``) the optimizer trains
data-parallel, as the JAX package's does: it takes global state only and
no variable with its own updater; the setup copies node 0's flat parameter
buffers into every node's before the state is set up, and each update runs
the hooks, then replaces each flat gradient by the grid's mean
(``nodeinfo.sumTensor``), then updates.  ``save`` and ``load`` ignore it.
"""

from collections import OrderedDict

import numpy as np
import torch

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch import hdf as hdfcodec
from puzzlelib_tpu_torch.backend import gpuarray
from puzzlelib_tpu_torch.convert import _stateName
from puzzlelib_tpu_torch.modules.module import loadInto
from puzzlelib_tpu_torch.variable import Variable


class Optimizer:
    def __init__(self, nodeinfo=None):
        self.t = 0
        self.learnRate = 0.0

        self.attrs = {"t", "learnRate"}

        self.module = None
        self.states = {}
        self.hooks = []

        self.shParams, self.shGrads = {}, {}

        self.globalState = False
        self.globalVar = OrderedDict()

        self.customVars = []
        self.nodeinfo = nodeinfo

    def setAttr(self, name, attr):
        setattr(self, name, attr)
        self.attrs.add(name)

    def getAttrDict(self):
        return {attrName: getattr(self, attrName) for attrName in self.attrs}

    def addHook(self, hook):
        if self.globalState and Config.showWarnings:
            Config.getLogger().info("Warning: adding hook to optimizer in global state mode")

        self.hooks.append(hook)

    # -- setup -------------------------------------------------------------------

    def setupOn(self, mod, useGlobalState=False):
        if self.nodeinfo is not None:
            assert useGlobalState, "an optimizer with a nodeinfo takes global state (useGlobalState=True)"

        self.module = mod
        vartable = self.module.getVarTable()

        self.globalState = useGlobalState
        if useGlobalState:
            self.setupGlobalState(vartable)
        else:
            self.setupLocalStates(vartable)

    def _partitionVars(self, vartable):
        """(first name, names, variable) of the variables the optimizer
        updates, ordered by first name; the names of those with their own
        updater go to ``customVars``."""
        managed = []

        for var, names in sorted(vartable.items(), key=lambda item: item[1][0]):
            if var.hasUpdater:
                self.customVars.append(names[0])
            else:
                managed.append((names[0], names, var))

        return managed

    def setupGlobalState(self, vartable):
        managed = self._partitionVars(vartable)

        if self.customVars:
            assert self.nodeinfo is None, "an optimizer with a nodeinfo takes no variable with its own updater"

        # one flat (param, grad) pair per dtype
        for lead, _, var in managed:
            dtype = var.data.dtype

            self.shParams.setdefault(dtype, gpuarray.SharedArray(dtype, var.data.device)).register(
                var.data.shape, dtype, lead)
            self.shGrads.setdefault(dtype, gpuarray.SharedArray(dtype, var.data.device)).register(
                var.grad.shape, dtype, lead)

        for dtype in self.shParams:
            self.shParams[dtype].build()
            self.shGrads[dtype].build()

            self.globalVar[dtype] = Variable(self.shParams[dtype].ary, grad=self.shGrads[dtype].ary)

        # copy the values in and rebind the module's variables as views
        for lead, names, var in managed:
            dtype = var.data.dtype
            view, gradView = self.shParams[dtype][lead], self.shGrads[dtype][lead]

            view.copy_(var.data)
            gradView.copy_(var.grad)

            for name in names:
                self.module.setVar(name, Variable(view, grad=gradView))

        # every node starts from node 0's weights
        for dtype, globalVar in self.globalVar.items():
            if self.nodeinfo is not None:
                self.nodeinfo.broadcastBuffer("data", globalVar.data)

            self.states[dtype] = self.setupState(globalVar)

    def setupLocalStates(self, vartable):
        for lead, _, var in self._partitionVars(vartable):
            self.states[lead] = self.setupState(var)

    def setupState(self, var):
        return {}

    # -- gradient clearing ------------------------------------------------------------

    def zeroGradParams(self):
        if self.globalState:
            for globalVar in self.globalVar.values():
                globalVar.grad.zero_()
        else:
            for name in self.states:
                self.module.getVar(name).grad.zero_()

    # -- update step --------------------------------------------------------------------

    def _refuseBlocks(self):
        """A ``FusedStep`` with ``stateShardings`` cuts a sharded variable's
        slots to this rank's block: only that step, which updates the
        matching block of the variable, may update or save them."""
        if self.globalState:
            return

        for name, state in self.states.items():
            shape = self.module.getVar(name).data.shape
            if any(entity.shape != shape for entity in state.values()):
                raise ValueError("the optimizer slots of %s hold one rank's block (FusedStep's stateShardings cut "
                                 "them): only that step updates them, and they are not saved whole" % name)

    def update(self):
        self._refuseBlocks()
        self.t += 1

        if self.globalState:
            for dtype, globalVar in self.globalVar.items():
                self._updateOne(globalVar, self.states[dtype])
        else:
            for name, state in self.states.items():
                self._updateOne(self.module.getVar(name), state)

        for name in self.customVars:
            self.module.getVar(name).update(self.learnRate)

    def _updateOne(self, var, state):
        for hook in self.hooks:
            hook(var, state)

        # one mean over the grid per flat gradient (a nodeinfo implies
        # global state)
        if self.nodeinfo is not None:
            self.nodeinfo.sumTensor("grad", var.grad)

        if var.learnRate > 0.0:
            self.updateVar(var, state)

    def updateVar(self, var, state):
        raise NotImplementedError()

    # -- optimizer-state persistence ---------------------------------------------------------

    def save(self, hdf, name=None):
        """Write the attributes and every state tensor into ``hdf`` (a path or
        an open handle)."""
        self._refuseBlocks()
        hdf, owned = hdfcodec.openStore(hdf, "w")
        prefix = name or ""

        try:
            if self.attrs:
                grp = hdf.require_group(prefix + ".attrs")
                for attrName, attr in self.getAttrDict().items():
                    hdfcodec.writeDataset(grp, attrName, attr)

            if self.states:
                grp = hdf.require_group(prefix + ".states")
                for key, state in self.states.items():
                    for entityName, entity in state.items():
                        hdfcodec.writeDataset(grp, "%s.%s" % (_stateName(key), entityName), entity)

        finally:
            if owned:
                hdf.close()

    def load(self, hdf, name=None):
        """Read the attributes (``t`` and the rates, through ``setAttr``) and
        every state tensor, in place, from ``hdf`` (a path, a file image or
        an open handle)."""
        hdf, owned = hdfcodec.openStore(hdf, "r")
        prefix = name or ""

        try:
            grpName = prefix + ".attrs"
            if grpName in hdf:
                for attrName, attr in hdf[grpName].items():
                    kind = type(getattr(self, attrName))
                    self.setAttr(attrName, kind(np.array(attr)))

            if self.states:
                grp = hdf[prefix + ".states"]
                for key, state in self.states.items():
                    for entityName, entity in state.items():
                        value = hdfcodec.readDataset(grp["%s.%s" % (_stateName(key), entityName)])
                        loadInto(entity, _rawBf16(value, entity))

        finally:
            if owned:
                hdf.close()


def _rawBf16(value, entity):
    """A bf16 state the JAX package wrote untagged (its raw 16 bits, opaque
    on disk) as a bf16 tensor; any other value as it is."""
    if isinstance(value, np.ndarray) and value.dtype.kind == "V" and value.dtype.itemsize == 2 and \
            entity.dtype == torch.bfloat16:
        return torch.from_numpy(np.ascontiguousarray(value).view(np.int16)).view(torch.bfloat16)

    return value
