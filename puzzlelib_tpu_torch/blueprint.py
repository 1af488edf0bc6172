"""Architecture serialization (counterpart of ``puzzlelib_tpu/blueprint.py``).

Every module records its constructor's arguments (``Module.registerBlueprint``);
a net's JSON blueprint, the JAX package's key for key, is stored inside its
HDF5 checkpoint (``save(..., withBlueprint=True)``), and ``BlueprintFactory``
rebuilds the architecture from it, with no init scheme, for ``load`` to fill
the weights.
"""

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch import hdf as hdfcodec
from puzzlelib_tpu_torch.containers.node import Node


class BlueprintError(Exception):
    pass


class BlueprintFactory:
    def __init__(self):
        import puzzlelib_tpu_torch.containers as containersPkg
        import puzzlelib_tpu_torch.modules as modulesPkg

        from puzzlelib_tpu_torch.containers.container import Container
        from puzzlelib_tpu_torch.modules.module import Module

        self.containers = {
            name: cls for name, cls in vars(containersPkg).items()
            if isinstance(cls, type) and issubclass(cls, Container) and cls is not Container
        }

        self.modules = {
            name: cls for name, cls in vars(modulesPkg).items()
            if isinstance(cls, type) and issubclass(cls, Module)
            and not issubclass(cls, Container) and cls is not Module
        }

        # container-shaped modules live outside the containers package (lazily
        # re-exported to dodge the import cycle, so vars() scans never see them)
        from puzzlelib_tpu_torch.modules.switchmoe import SwitchMoE
        self.containers["SwitchMoE"] = SwitchMoE

    def build(self, blueprint, log=False):
        classname, scheme = blueprint["classname"], blueprint["scheme"]

        if classname in self.containers:
            graph, elements = blueprint["graph"], blueprint["modules"]

            if classname in {"Sequential", "Parallel", "Pipeline"}:
                mod = self.containers[classname](name=scheme["name"])

                for name in graph:
                    mod.append(self.build(elements[name], log=log))

            elif classname == "Graph":
                nodes = {name: Node(self.build(bprint, log=log)) for name, bprint in elements.items()}

                for node in nodes.values():
                    node.addBackwards([(nodes[name], slots) for name, slots in graph[node.name]])

                inputs = [nodes[name] for name in blueprint["inputs"]]
                outputs = [nodes[name] for name in blueprint["outputs"]]

                mod = self.containers[classname](inputs, outputs, name=scheme["name"])

            else:
                # scheme-carrying containers (SwitchMoE): ctor kwargs from the
                # scheme, then the recorded children appended in graph order
                mod = self.containers[classname](**scheme)

                for name in graph:
                    mod.append(self.build(elements[name], log=log))

        elif classname in self.modules:
            if "initscheme" in scheme:
                scheme = dict(scheme)
                scheme["initscheme"] = "none"

            mod = self.modules[classname](**scheme)

        else:
            raise BlueprintError("Cannot build module with class name '%s'" % classname)

        if log:
            Config.getLogger().info("Loaded %s", mod)

        return mod


def load(hdf, name=None, assumeUniqueNames=False, log=False):
    """Rebuild a net from the blueprint in ``hdf`` (a path, the ``bytes``
    image ``save()`` returns, or an open handle) and load its weights."""
    hdf, owned = hdfcodec.openStore(hdf, "r")

    try:
        blueprint = hdfcodec.fetchBlueprint(hdf)

        if log:
            Config.getLogger().info("Building model from blueprint ...")

        mod = BlueprintFactory().build(blueprint, log=log)

        if log:
            Config.getLogger().info("Loading model data ...")

        mod.load(hdf, name=name, assumeUniqueNames=assumeUniqueNames, isRoot=False)

    finally:
        if owned:
            hdf.close()

    return mod
