"""Sequential container (counterpart of
``puzzlelib_tpu/containers/sequential.py``).  The pipeline order is the
order of ``append``; ``backward`` walks it in reverse.

The reference's inplace-compatibility check is kept: an inplace module may
not consume the output of a producer whose backward re-reads its own output
(``gradUsesOutData``), looking through modules that only move data.
Slicing and ``insert`` come with the slices that need them; the lookups
``getByName`` / ``getAllByType`` are the base ``Container``'s."""

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.modules.module import ModuleError
from puzzlelib_tpu_torch.containers.container import Container, ContainerError


class Sequential(Container):
    @property
    def graph(self):
        return list(self._modules.values())

    # -- dataflow hints --------------------------------------------------------------

    @property
    def gradUsesOutData(self):
        # the container's flag is that of its last child that does not only
        # move data
        for mod in reversed(self.graph):
            if not mod.movesData:
                return mod.gradUsesOutData

        return False

    @gradUsesOutData.setter
    def gradUsesOutData(self, val):
        pass

    @staticmethod
    def _edgeIsInplace(mods, moverFlag):
        """True if the first module at this end that is no mover is inplace."""
        for mod in mods:
            if getattr(mod, moverFlag):
                continue

            return bool(getattr(mod, "inplace", False))

        return True

    @property
    def inplace(self):
        return (self._edgeIsInplace(self.graph, "movesData") or
                self._edgeIsInplace(reversed(self.graph), "movesGrad"))

    # -- pipeline editing --------------------------------------------------------------

    def append(self, mod, acquire=True):
        if self._modules:
            self.checkModulesCompatibility(self.graph[-1], mod)

        return super().append(mod, acquire)

    def extend(self, container, acquire=True):
        """Append every module of ``container`` (a Sequential or a list), in
        order; a name already taken is replaced by the module's index, as
        ``append`` does."""
        mods = container.graph if isinstance(container, Sequential) else container

        for mod in mods:
            self.append(mod, acquire)

    def pop(self):
        return self.removeModule(self.graph[-1])

    def checkModulesCompatibility(self, before, incoming):
        if Config.disableModuleCompatChecks or not getattr(incoming, "inplace", False):
            return

        # the module whose output the inplace module would overwrite: before
        # itself, or the producer behind the data movers before it
        if before.gradUsesOutData:
            hazard = before
        else:
            graph = self.graph
            index = self.getModuleIndex(before.name)
            while index >= 0 and graph[index].movesData:
                index -= 1

            hazard = graph[index] if index >= 0 and graph[index].gradUsesOutData else None

        if hazard is not None:
            raise ContainerError("%s: Can't insert inplace module %s after module %s (gradient uses outdata)" %
                                 (self, incoming, hazard))

    # -- lookup ------------------------------------------------------------------------

    def __getitem__(self, item):
        if isinstance(item, int):
            return self.graph[item]

        return super().__getitem__(item)

    def getModuleIndex(self, name):
        for index, mod in enumerate(self.graph):
            if mod.name == name:
                return index

        raise ContainerError("%s: Module %s not found" % (self, name))

    # -- forward / backward ----------------------------------------------------------

    def _childFailure(self, kind, index, mod, exc):
        if isinstance(exc, ModuleError):
            raise ModuleError("%s:\n%s error in module %d (%s):\n%s" % (self, kind, index, mod, exc))

        self.handleError(mod, exc)

    def updateData(self, data):
        flowing = data

        for index, mod in enumerate(self.graph):
            try:
                mod(flowing)
            except Exception as e:
                self._childFailure("Data", index, mod, e)

            flowing = mod.data

        self.data = flowing

    def backward(self, grad, updParamGrads=True, updGrad=True, scale=1.0, momentum=1.0):
        flowing = grad
        graph = self.graph

        for index in range(len(graph) - 1, -1, -1):
            mod = graph[index]

            # only the head honours the caller's updGrad: every other module
            # gives its predecessor an input gradient
            try:
                mod.backward(flowing, updParamGrads=updParamGrads, updGrad=updGrad if index == 0 else True,
                             scale=scale, momentum=momentum)
            except Exception as e:
                self._childFailure("Grad", index, mod, e)

            flowing = mod.grad

        self.grad = flowing

    def dataShapeFrom(self, shape):
        for mod in self.graph:
            shape = mod.dataShapeFrom(shape)

        return shape

    def gradShapeFrom(self, shape):
        for mod in reversed(self.graph):
            shape = mod.gradShapeFrom(shape)

        return shape
