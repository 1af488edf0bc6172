"""Container base: a Module owning named child modules (counterpart of
``puzzlelib_tpu/containers/container.py``).

The reference keeps its children in a ``modules`` dict, which would shadow
``nn.Module.modules()``.  Here children are registered with ``add_module``
and live in ``nn.Module``'s own registry, so ``net["conv3_1"]``, the
variable routing (``net.getVar("conv3_1.W")``) and ``nn.Module``'s
``modules()``, ``parameters()`` and ``.to()`` all see the same tree.  A
child's name must not clash with an attribute of the container.
"""

from puzzlelib_tpu_torch.modules.module import Module, ModuleError


class ContainerError(ModuleError):
    pass


class Container(Module):
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

    def handleError(self, mod, e):
        detail = str(e)
        raise ContainerError("%s:\nModule (%s) error:\n%s%s" %
                             (self, mod, type(e), ": %s" % detail if detail else ""))

    def __str__(self):
        return "Container %s (name: %s)" % (type(self).__name__, self.name)
