"""DAG node wiring modules into a Graph container (counterpart of
``puzzlelib_tpu/containers/node.py``).

Nodes wire with ``module.node(*parents)``; a parent may be a bare Node or a
``(node, slots)`` tuple routing specific output slots.  Traversal is an
iterative ready-set sweep: a worklist pops a node, skips it until every
dependency fired, applies the visitor and pushes its successors, so a node
with several roots runs once, after all of them, and deep graphs need no
recursion.
"""

from puzzlelib_tpu_torch.backend import blas as Blas


class NodeError(Exception):
    pass


def _asLinks(parents):
    """Normalize a ctor ``parents`` argument into a flat [(node, slots)] list."""
    if parents is None:
        return []

    if isinstance(parents, Node):
        return [(parents, None)]

    if isinstance(parents, tuple):
        node, slots = parents
        if slots is not None and not isinstance(slots, list):
            slots = [slots]

        return [(node, slots)]

    if isinstance(parents, list):
        links = []
        for entry in parents:
            links.extend(_asLinks(entry))

        return links

    raise NodeError("Unrecognized parent object type %s" % type(parents).__name__)


def _outputWidth(node):
    """Number of output slots a node produced on its last forward."""
    return len(node.data) if isinstance(node.data, list) else 1


class Node:
    def __init__(self, mod, parents=None, name=None):
        self.module, self.rename = mod, name

        self.data, self.grad = None, None
        self.fwds, self.bwds = [], []
        self.fwdVisited, self.bwdVisited = False, False

        self.addBackwards(parents)

    @property
    def name(self):
        return self.rename if self.rename is not None else self.module.name

    # -- wiring ----------------------------------------------------------------

    def addBackwards(self, nodes):
        for parent, slots in _asLinks(nodes):
            parent.addForward((self, slots))
            self.bwds.append((parent, slots))

    def addForward(self, link):
        self.fwds.append(link)

    # -- traversal -------------------------------------------------------------

    @staticmethod
    def _sweep(start, visitor, args, flag, deps, succs):
        pending = [start]

        while pending:
            node = pending.pop()
            if getattr(node, flag):
                continue

            if not all(getattr(dep, flag) for dep, _ in deps(node)):
                # not ready yet: the sweep from whichever root completes the
                # missing dependency will re-push this node
                continue

            visitor(node, *args)
            setattr(node, flag, True)

            pending.extend(nxt for nxt, _ in reversed(succs(node)))

    @staticmethod
    def traverseForward(node, func, *args):
        Node._sweep(node, func, args, "fwdVisited", lambda n: n.bwds, lambda n: n.fwds)

    @staticmethod
    def traverseBackward(node, func, *args):
        Node._sweep(node, func, args, "bwdVisited", lambda n: n.fwds, lambda n: n.bwds)

    # -- forward ----------------------------------------------------------------

    def _gatherInputs(self, external):
        """Collect this node's module input from parent outputs (or the graph
        feed for source nodes), honoring slot routing."""
        if not self.bwds:
            return external

        head, headSlots = self.bwds[0]
        if headSlots is None and len(self.bwds) == 1:
            return head.data

        feed = []
        for parent, slots in self.bwds:
            feed += [parent.data] if slots is None else [parent.data[s] for s in slots]

        return feed

    def updateData(self, data):
        self.data = self.module(self._gatherInputs(data))

    def forward(self, data):
        self.traverseForward(self, Node.updateData, data)

    def dataShapeFrom(self, inshapes, shapes, onmodule):
        if not self.bwds:
            inshape = inshapes[self.name]
        else:
            feed = []
            for parent, slots in self.bwds:
                feed += [shapes[parent.name]] if slots is None else [shapes[parent.name][s] for s in slots]

            inshape = feed[0] if len(self.bwds) == 1 else feed

        shapes[self.name] = self.module.dataShapeFrom(inshape)

        if onmodule is not None:
            onmodule(self.module, inshape)

    # -- backward ---------------------------------------------------------------

    @staticmethod
    def _fanInSum(grads):
        """Sum gradient contributions from several consumers of one slot, in
        a new tensor (the contributions may be shared objects: ``Add`` hands
        one gradient to all its inputs).  The sum keeps the first one's
        layout, and adds elementwise: a conv on the card hands back
        channels-last gradients, which no flat view covers, and the layout
        the next backward takes decides its bits, as in a Sequential."""
        if len(grads) == 1:
            return grads[0]

        total = grads[0].clone()
        for extra in grads[1:]:
            Blas.toVectorAddVector(total, extra)

        return total

    def buildOutGrad(self, grad):
        """Assemble this node's output gradient from its consumers (or the
        external grad for sink nodes), summing fan-in per slot."""
        if not self.fwds:
            return grad

        buckets = [[] for _ in range(_outputWidth(self))]

        for child, slots in self.fwds:
            contribution = child.grad[self.name]
            if slots is None:
                for i, g in enumerate(contribution):
                    buckets[i].append(g)
            else:
                for s in slots:
                    buckets[s].append(contribution[s])

        summed = [self._fanInSum(b) for b in buckets]
        return summed[0] if len(summed) == 1 else summed

    def routeInGrad(self, grad):
        """Split the module's input gradient back to parents by edge order."""
        if not self.bwds:
            return grad

        flat = grad if isinstance(grad, list) else [grad]
        routed, cursor = {}, 0

        for parent, slots in self.bwds:
            if slots is None:
                width = _outputWidth(parent)
                routed[parent.name] = flat[cursor:cursor + width]
            else:
                width = len(slots)
                routed[parent.name] = dict(zip(slots, flat[cursor:cursor + width]))

            cursor += width

        return routed

    def updateGrad(self, grad, updParamGrads, updGrad, scale, momentum):
        outgrad = self.buildOutGrad(grad)

        # interior nodes always need their input gradient for upstream fan-out
        needInGrad = True if self.bwds else updGrad
        self.module.backward(outgrad, updParamGrads=updParamGrads, updGrad=needInGrad,
                             scale=scale, momentum=momentum)

        self.grad = self.routeInGrad(self.module.grad)

    def backward(self, grad=None, updParamGrads=True, updGrad=True, scale=1.0, momentum=0.0):
        self.traverseBackward(self, Node.updateGrad, grad, updParamGrads, updGrad, scale, momentum)

    def gradShapeFrom(self, outshapes, shapes):
        shapes[self.name] = self.routeInGrad(self.module.gradShapeFrom(self.buildOutGradShape(outshapes, shapes)))

    def buildOutGradShape(self, outshapes, shapes):
        if not self.fwds:
            return outshapes[self.name]

        slotShapes = [None] * _outputWidth(self)

        for child, slots in self.fwds:
            contribution = shapes[child.name][self.name]
            if slots is None:
                slotShapes = list(contribution)
            else:
                for s in slots:
                    slotShapes[s] = contribution[s]

        return slotShapes[0] if len(slotShapes) == 1 else slotShapes

    # -- housekeeping -------------------------------------------------------------

    def clearTraverse(self):
        self.fwdVisited = self.bwdVisited = False

    def reset(self):
        self.clearTraverse()
        self.data, self.grad = None, None
        self.module.reset()

    def __str__(self):
        return "Node %s (name: %s)" % (type(self.module), self.name)
