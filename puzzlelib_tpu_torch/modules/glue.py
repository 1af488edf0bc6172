"""A module of user hooks (counterpart of
``puzzlelib_tpu/modules/glue.py``): ``fwdGlue(data, modules)`` and
``bwdGlue(grad, modules)`` compute the output and the input gradient from
the port's tensors and the optional dictionary of inner modules, which
they drive themselves; ``fwdShapeGlue`` / ``bwdShapeGlue`` answer the shape
queries.  The dictionary is kept as ``glueModules`` (``nn.Module`` owns the
name ``modules``), and its modules are no children of this one, as the
reference's are in no variable table of it.  Unlike the reference's,
``calcMode`` takes any type the port allows and sets the inner modules'
too."""

from puzzlelib_tpu_torch.modules.module import ModuleError, Module


class Glue(Module):
    def __init__(self, modules=None, fwdGlue=None, bwdGlue=None, fwdShapeGlue=None, bwdShapeGlue=None, name=None):
        super().__init__(name)

        if modules is not None and not isinstance(modules, dict):
            raise ModuleError("Modules object must be non-empty dictionary")

        self.glueModules = modules

        self.fwdGlue, self.bwdGlue = fwdGlue, bwdGlue
        self.fwdShapeGlue, self.bwdShapeGlue = fwdShapeGlue, bwdShapeGlue

    def updateData(self, data):
        self.data = self.fwdGlue(data, self.glueModules)

    def updateGrad(self, grad):
        self.grad = self.bwdGlue(grad, self.glueModules)

    def dataShapeFrom(self, shape):
        if self.fwdShapeGlue is None:
            raise ModuleError("Forward shape glue hook is not installed")

        return self.fwdShapeGlue(shape)

    def gradShapeFrom(self, shape):
        if self.bwdShapeGlue is None:
            raise ModuleError("Backward shape glue hook is not installed")

        return self.bwdShapeGlue(shape)

    def calcMode(self, T):
        self.supportedDtypesCalcMode(T)

        for mod in (self.glueModules or {}).values():
            mod.calcMode(T)
