"""Rewrite Sequential and Parallel containers into one flat Graph
(counterpart of ``puzzlelib_tpu/passes/converttograph.py``).

Every leaf module becomes a ``Node`` of the new ``Graph`` (the same module
object, so the graph holds the net's weights); a Graph inside is opened
into its nodes.  ``Identity``, ``Replicate`` and ``ToList`` become wiring
only; ``Glue`` refuses, since its function may read its inputs in any way.
Nested nodes are named ``<container path>_<module name>`` unless
``assumeUniqueNames`` is set.
"""

from puzzlelib_tpu_torch.containers.sequential import Sequential
from puzzlelib_tpu_torch.containers.parallel import Parallel
from puzzlelib_tpu_torch.containers.graph import Graph
from puzzlelib_tpu_torch.containers.node import Node

from puzzlelib_tpu_torch.modules import Identity, Replicate, ToList, Glue


class ConverterError(Exception):
    pass


def toGraph(module, unsafe=False, nodesOnly=False, assumeUniqueNames=False):
    inputs, outputs = convertToGraph(module, None, None, assumeUniqueNames)
    return Graph(inputs=inputs, outputs=outputs, unsafe=unsafe, nodesOnly=nodesOnly, name=module.name)


def convertToGraph(module, inputs, name, assumeUniqueNames):
    if isinstance(module, Sequential):
        return convertSequential(module, inputs, name, assumeUniqueNames)
    elif isinstance(module, Parallel):
        return convertParallel(module, inputs, name, assumeUniqueNames)
    elif isinstance(module, Graph):
        return convertGraph(module, inputs, name, assumeUniqueNames)
    else:
        return convertModule(module, inputs, name, assumeUniqueNames)


def _childName(mod, name, assumeUniqueNames):
    if assumeUniqueNames:
        return None

    return "%s_%s" % (name, mod.name) if name is not None else mod.name


def convertSequential(seq, inputs, name, assumeUniqueNames):
    outputs = inputs

    for mod in seq.graph:
        newInputs, outputs = convertToGraph(mod, outputs, _childName(mod, name, assumeUniqueNames),
                                            assumeUniqueNames)
        inputs = inputs if inputs is not None else newInputs

    return inputs, outputs


def convertParallel(parallel, inputs, name, assumeUniqueNames):
    overwriteInputs = inputs is None

    if overwriteInputs:
        inputs = []

    outputs = []
    for mod in parallel.graph:
        newInputs, newOutputs = convertToGraph(mod, inputs, _childName(mod, name, assumeUniqueNames),
                                               assumeUniqueNames)
        if overwriteInputs:
            inputs.extend(newInputs)

        outputs.extend(newOutputs)

    return inputs, outputs


def convertGraph(graph, inputs, name, assumeUniqueNames):
    nodes = {}

    for node in graph.nodes.values():
        modname = None if assumeUniqueNames else (node.name if name is None else "%s_%s" % (name, node.name))

        newInputs, newOutputs = convertToGraph(node.module, None, name=modname,
                                               assumeUniqueNames=assumeUniqueNames)
        nodes[node.name] = (newInputs, newOutputs, node.name)

    for nodeInputs, nodeOutputs, nodename in nodes.values():
        if not isinstance(nodeInputs, list):
            nodeInputs = [nodeInputs]

        for inp in nodeInputs:
            inp.addBackwards([(nodes[n.name][1][0], slots) for n, slots in graph.nodes[nodename].bwds])

    newInputs = [nodes[inp.name][0] for inp in graph.inputs]
    newOutputs = [nodes[output.name][1] for output in graph.outputs]

    for i, inp in enumerate(newInputs):
        inp.addBackwards(inputs[i] if inputs is not None else None)

    return inputs if inputs is not None else newInputs, newOutputs


def convertModule(module, inputs, name, _):
    if isinstance(module, (Identity, Replicate, ToList)):
        return inputs, inputs

    if isinstance(module, Glue):
        raise ConverterError("Cannot convert Glue module - result may be unpredictable")

    node = Node(module, parents=inputs, name=name)
    inputs = inputs if inputs is not None else node

    return inputs, [node]
