"""DAG container (counterpart of ``puzzlelib_tpu/containers/graph.py``).

Wraps a web of Nodes (built with ``module.node(*parents)``) behind the
standard Module interface.  Every node's module is appended as a child, so
``calcMode``, ``evalMode``, ``reset``, ``getVarTable`` and ``nn.Module``'s
registry reach all of them under their node names.  Forward feeds every input
node and sweeps to the outputs; backward seeds every output node and sweeps
upstream, summing gradient fan-in at each node.  ``getBlueprint`` records
the edges, inputs and outputs, from which ``blueprint.BlueprintFactory``
rebuilds the graph.
"""

from puzzlelib_tpu_torch.containers.container import ContainerError, Container
from puzzlelib_tpu_torch.containers.node import Node


def _aslist(obj):
    return obj if isinstance(obj, list) else [obj]


def _single(values):
    return values[0] if len(values) == 1 else values


class Graph(Container):
    def __init__(self, inputs, outputs, unsafe=False, nodesOnly=False, name=None):
        super().__init__(name)

        self.unsafe = unsafe
        self.inputs, self.outputs = _aslist(inputs), _aslist(outputs)

        badInputs = [node.name for node in self.inputs if node.bwds]
        if badInputs:
            raise ContainerError("Found input nodes with parents: %s" % ", ".join(badInputs))

        badOutputs = [node.name for node in self.outputs if node.fwds]
        if badOutputs:
            raise ContainerError("Found output nodes with ancestors: %s" % ", ".join(badOutputs))

        self.nodes = {}
        for inp in self.inputs:
            inp.traverseForward(inp, lambda node: self.gatherTopology(node, nodesOnly))

        missed = [node.name for node in self.outputs if not node.fwdVisited]
        if missed:
            raise ContainerError("Could not visit output nodes: %s" % ", ".join(missed))

        self.reset()

    def gatherTopology(self, node, nodesOnly):
        if not nodesOnly:
            self.append(node.module)

        if node.name in self.nodes:
            raise ContainerError("Found two nodes named %s" % node.name)

        self.nodes[node.name] = node

        if self.unsafe or not getattr(node.module, "inplace", False):
            return

        # an inplace node must have trivially-wired neighbors or buffers alias
        for child, _ in node.fwds:
            if len(child.bwds) > 1:
                raise ContainerError("Invalid inplace mode - module %s has non-trivial ancestor %s" %
                                     (node.module, child))

        for parent, _ in node.bwds:
            if len(parent.fwds) > 1:
                raise ContainerError("Invalid inplace mode - module %s has non-trivial parent %s" %
                                     (node.module, parent))

    def getNodeByName(self, name):
        return self.nodes[name]

    # -- forward / backward ------------------------------------------------------------

    def getBlueprint(self):
        blueprint = super().getBlueprint()

        blueprint["graph"] = {
            node.name: [(parent.name, slots) for parent, slots in node.bwds]
            for node in self.nodes.values()
        }
        blueprint["inputs"] = [node.name for node in self.inputs]
        blueprint["outputs"] = [node.name for node in self.outputs]

        return blueprint

    def updateData(self, data):
        feeds = _aslist(data)
        if len(feeds) != len(self.inputs):
            raise ContainerError("Graph expects %d inputs, got %d" % (len(self.inputs), len(feeds)))

        for node, feed in zip(self.inputs, feeds):
            node.forward(feed)

        self.data = _single([node.data for node in self.outputs])
        self.clearTraverse()

    def backward(self, grad, updParamGrads=True, updGrad=True, scale=1.0, momentum=1.0):
        feeds = _aslist(grad)
        if len(feeds) != len(self.outputs):
            raise ContainerError("Graph expects %d output grads, got %d" % (len(self.outputs), len(feeds)))

        for node, feed in zip(self.outputs, feeds):
            node.backward(feed, updParamGrads=updParamGrads, updGrad=updGrad,
                          scale=scale, momentum=momentum)

        self.grad = _single([node.grad for node in self.inputs])
        self.clearTraverse()

    def updateGrad(self, grad):
        raise ContainerError("Graph runs its backward through backward(), node by node")

    # -- shape propagation ----------------------------------------------------------------

    def graphDataShape(self, shape, onmodule):
        inshapes = {node.name: sh for node, sh in zip(self.inputs, _aslist(shape))}
        shapes = {}

        for node in self.inputs:
            node.traverseForward(node, Node.dataShapeFrom, inshapes, shapes, onmodule)

        self.clearTraverse()
        return _single([shapes[node.name] for node in self.outputs])

    def dataShapeFrom(self, shape):
        return self.graphDataShape(shape, None)

    def optimizeForShape(self, shape, memlimit=None):
        self.graphDataShape(shape, lambda module, sh: module.optimizeForShape(sh, memlimit))

    def gradShapeFrom(self, shape):
        outshapes = {node.name: sh for node, sh in zip(self.outputs, _aslist(shape))}
        shapes = {}

        for node in self.outputs:
            node.traverseBackward(node, Node.gradShapeFrom, outshapes, shapes)

        self.clearTraverse()
        return _single([shapes[node.name] for node in self.inputs])

    # -- housekeeping --------------------------------------------------------------------------

    def reset(self):
        super().reset()
        for node in self.nodes.values():
            node.reset()

    def clearTraverse(self):
        for node in self.nodes.values():
            node.clearTraverse()
