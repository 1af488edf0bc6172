"""Sequential container, forward (counterpart of
``puzzlelib_tpu/containers/sequential.py``).  The pipeline order is the
order of ``append``.  The reference's inplace-compatibility check guards its
backward pass and comes with it; so do slicing, ``extend`` and the lookups
by name and type, which nothing on the serving path calls."""

from puzzlelib_tpu_torch.modules.module import ModuleError
from puzzlelib_tpu_torch.containers.container import Container


class Sequential(Container):
    @property
    def graph(self):
        return list(self._modules.values())

    def __getitem__(self, item):
        if isinstance(item, int):
            return self.graph[item]

        return super().__getitem__(item)

    def _childFailure(self, index, mod, exc):
        if isinstance(exc, ModuleError):
            raise ModuleError("%s:\nData error in module %d (%s):\n%s" % (self, index, mod, exc))

        self.handleError(mod, exc)

    def updateData(self, data):
        flowing = data

        for index, mod in enumerate(self.graph):
            try:
                mod(flowing)
            except Exception as e:
                self._childFailure(index, mod, e)

            flowing = mod.data

        self.data = flowing

    def dataShapeFrom(self, shape):
        for mod in self.graph:
            shape = mod.dataShapeFrom(shape)

        return shape
