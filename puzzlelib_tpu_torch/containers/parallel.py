"""Branch-parallel container over a list of inputs (counterpart of
``puzzlelib_tpu/containers/parallel.py``): N sibling modules, each fed the
matching element of a list input (the residual block's branch and shortcut,
Inception towers).  The branches run in turn, in the order of ``append``;
the output and the input gradient are lists in the same order.  The
backward's ``momentum`` defaults to 1.0, as the reference's does: the
branches add their parameter gradients to the buffers the optimizer cleared.
"""

from puzzlelib_tpu_torch.modules.module import ModuleError
from puzzlelib_tpu_torch.containers.container import Container


class Parallel(Container):
    @property
    def graph(self):
        return list(self._modules.values())

    # -- dataflow hints ------------------------------------------------------------

    @property
    def gradUsesOutData(self):
        return any(branch.gradUsesOutData for branch in self.graph)

    @gradUsesOutData.setter
    def gradUsesOutData(self, val):
        pass

    @property
    def inplace(self):
        return any(getattr(branch, "inplace", False) for branch in self.graph[:-1])

    # -- branch editing --------------------------------------------------------------

    def extend(self, container, acquire=True):
        branches = container.graph if isinstance(container, Parallel) else container

        for mod in branches:
            self.append(mod, acquire)

    def pop(self):
        return self.removeModule(self.graph[-1])

    def __getitem__(self, item):
        if isinstance(item, int):
            return self.graph[item]

        if isinstance(item, slice):
            sub = Parallel()
            sub.extend(self.graph[item])
            return sub

        return super().__getitem__(item)

    def getBlueprint(self):
        blueprint = super().getBlueprint()
        blueprint["graph"] = [branch.name for branch in self.graph]

        return blueprint

    def getByIndex(self, index):
        return self.graph[index]

    # -- forward / backward -------------------------------------------------------------

    def _eachBranch(self, inputs, kind, visit):
        """Apply ``visit`` to every (branch, input) pair, with error context."""
        assert len(inputs) == len(self.graph)
        results = []

        for index, (branch, feed) in enumerate(zip(self.graph, inputs)):
            try:
                results.append(visit(branch, feed))
            except ModuleError as e:
                raise ModuleError("%s:\n%s error in module %d (%s):\n%s" % (self, kind, index, branch, e))
            except Exception as e:
                self.handleError(branch, e)

        return results

    def updateData(self, data):
        self.data = self._eachBranch(data, "Data", lambda branch, feed: branch(feed))

    def backward(self, grad, updParamGrads=True, updGrad=True, scale=1.0, momentum=1.0):
        def visit(branch, feed):
            branch.backward(feed, updParamGrads=updParamGrads, updGrad=updGrad, scale=scale, momentum=momentum)
            return branch.grad

        self.grad = self._eachBranch(grad, "Grad", visit)

    def dataShapeFrom(self, shapes):
        return [branch.dataShapeFrom(shape) for branch, shape in zip(self.graph, shapes)]

    def optimizeForShape(self, shapes, memlimit=None):
        """Each branch at its own input's shape."""
        for branch, shape in zip(self.graph, shapes):
            branch.optimizeForShape(shape, memlimit)

    def gradShapeFrom(self, shapes):
        return [branch.gradShapeFrom(shape) for branch, shape in zip(self.graph, shapes)]

    def updateGrad(self, grad):
        assert False
