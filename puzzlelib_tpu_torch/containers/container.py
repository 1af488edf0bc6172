"""Container base: a Module owning named child modules (counterpart of
``puzzlelib_tpu/containers/container.py``).

Children are registered with ``add_module`` and live in ``nn.Module``'s own
registry, so ``net["conv3_1"]``, the variable routing
(``net.getVar("conv3_1.W")``) and ``nn.Module``'s ``parameters()`` and
``.to()`` all see the same tree.  ``net.modules`` is the reference's
``modules`` dict as a view of that registry (``ModulesView``): the children
by name, in insertion order, so ``net.modules["conv1_1"]`` and
``net.modules.items()`` work as in the reference.  Called, the view is
``nn.Module.modules()``, which PyTorch's own code calls.  A child's name must
not clash with an attribute of the container.

Checkpoints follow the JAX package's layout: each child saves and loads
itself under its dotted path ("<container>.<child>"), a container never
squashes its own path (``assumeUniqueNames`` acts at the leaves), and the
container's own attributes (a net's timestamp, a preset's sentence length)
go in the group ``attrs.<path>``, each as "<container name>.<attr>".
"""

from collections.abc import Mapping

from torch import nn

from puzzlelib_tpu_torch import hdf as hdfcodec
from puzzlelib_tpu_torch.modules.module import Module, ModuleError, hostValue, loadInto


class ContainerError(ModuleError):
    pass


class ModulesView(Mapping):
    """A container's children by name, read-only, in insertion order (the
    reference's ``Container.modules`` dict); calling it yields every module
    of the tree, the container first, as ``nn.Module.modules()`` does."""

    __slots__ = ("_owner", )

    def __init__(self, owner):
        self._owner = owner

    def __getitem__(self, name):
        return self._owner._modules[name]

    def __iter__(self):
        return iter(self._owner._modules)

    def __len__(self):
        return len(self._owner._modules)

    def __call__(self):
        return nn.Module.modules(self._owner)


class Container(Module):
    _errorKind = "Container"
    _errorType = ContainerError

    @property
    def modules(self):
        return ModulesView(self)

    # -- child registry ----------------------------------------------------------

    def append(self, mod, acquire=True):
        if mod.name is None:
            mod.name = str(len(self._modules))

        elif mod.name in self._modules:
            if not acquire:
                raise ContainerError("Module with name '%s' is already in container" % mod.name)

            mod.name = str(len(self._modules))

        self.add_module(mod.name, mod)
        return self

    def removeModule(self, mod):
        del self._modules[mod.name]
        return mod

    def __getitem__(self, item):
        if not isinstance(item, str):
            raise NotImplementedError(type(item).__name__)

        return self._modules[item]

    def getByName(self, name):
        """The module of the tree named ``name``: a child of this container,
        else the first found in a child container, depth first; None if
        there is none."""
        found = self._modules.get(name)

        if found is None:
            for child in self._modules.values():
                if isinstance(child, Container):
                    found = child.getByName(name)
                    if found is not None:
                        break

        return found

    def getAllByType(self, typ):
        """Every module of the tree that is a ``typ``, depth first; a
        container that is one is not searched further."""
        matches = []

        for child in self._modules.values():
            if isinstance(child, typ):
                matches.append(child)
            elif isinstance(child, Container):
                matches.extend(child.getAllByType(typ))

        return matches

    # -- variable routing ------------------------------------------------------------

    def _route(self, name):
        """Split 'child.rest' at the first dot."""
        child, dot, rest = name.partition(".")

        if not dot:
            raise ContainerError("Cannot find dot-delimiter in variable name: %s" % name)

        return self._modules[child], rest

    def setVar(self, name, var):
        child, rest = self._route(name)
        child.setVar(rest, var)

    def getVar(self, name):
        child, rest = self._route(name)
        return child.getVar(rest)

    def getVarTable(self, vartable=None, name=None, root=True):
        prefix = "" if root else name

        if vartable is None:
            vartable = {}

        for child in self._modules.values():
            child.getVarTable(vartable, "%s%s." % (prefix, child.name), root=False)

        return vartable

    def getAttrTable(self, attrtable=None, name=None, root=True):
        prefix = "" if root else name

        if attrtable is None:
            attrtable = {}

        for child in self._modules.values():
            child.getAttrTable(attrtable, "%s%s." % (prefix, child.name), root=False)

        return attrtable

    # -- aggregate module protocol ------------------------------------------------------

    def zeroGradParams(self):
        for child in self._modules.values():
            child.zeroGradParams()

    def updateParams(self, learnRate):
        for child in self._modules.values():
            child.updateParams(learnRate)

    def genericCheckDataType(self, dtype):
        pass

    def trainMode(self):
        super().trainMode()
        for child in self._modules.values():
            child.trainMode()

    def evalMode(self):
        super().evalMode()
        for child in self._modules.values():
            child.evalMode()

    def calcMode(self, T):
        for child in self._modules.values():
            try:
                child.calcMode(T)
            except Exception as e:
                self.handleError(child, e)

        # the handlers read the container's type to upload host data in it
        self.calctype = self.requireSupportedDtype(T)

    def reset(self):
        super().reset()
        for child in self._modules.values():
            child.reset()

    def numOfParams(self):
        return sum(child.numOfParams() for child in self._modules.values())

    # -- persistence ------------------------------------------------------------------------

    def _checkpointPath(self, name, assumeUniqueNames):
        # containers never squash their own path; children apply the
        # unique-names squash at their own level
        return name if name is not None else (self.name or "")

    def _attrKey(self, name):
        return "%s.%s" % (self.name or "", name)

    def _writeState(self, hdf, varlinks, name, compress, assumeUniqueNames=False):
        for child in self._modules.values():
            child.save(hdf, varlinks, "%s.%s" % (name, child.name), compress=compress,
                       assumeUniqueNames=assumeUniqueNames, isRoot=False)

        # container attrs live in their own group (made also when empty), each
        # under "<container name>.<attr>"
        group = "attrs.%s" % name
        hdf.require_group(group)
        hdfcodec.storeAttrs(hdf, {self._attrKey(attrName): attr for attrName, attr in
                                  {**self.attrs, **self.hostAttrs}.items()}, compress=None, group=group)

    def _readState(self, hdf, initvars, name, assumeUniqueNames):
        for child in self._modules.values():
            child.load(hdf, initvars, "%s.%s" % (name, child.name),
                       assumeUniqueNames=assumeUniqueNames, isRoot=False)

        group = "attrs.%s" % name
        if group not in hdf:
            return

        prefix = self._attrKey("")
        for key, dataset in hdf[group].items():
            attrName = key[len(prefix):] if key.startswith(prefix) else key.partition(".")[2]
            value = hdfcodec.readDataset(dataset)

            if attrName in self.attrs:
                loadInto(self.attrs[attrName], value)
            else:
                self.setAttr(attrName, hostValue(value))

    # -- blueprint / misc -----------------------------------------------------------------------

    def getBlueprint(self):
        blueprint = super().getBlueprint()
        blueprint["modules"] = {name: child.getBlueprint() for name, child in self._modules.items()}

        return blueprint

    def handleError(self, mod, e):
        detail = str(e)
        raise ContainerError("%s:\nModule (%s) error:\n%s%s" %
                             (self, mod, type(e), ": %s" % detail if detail else ""))

    def __str__(self):
        return "Container %s (name: %s)" % (type(self).__name__, self.name)
