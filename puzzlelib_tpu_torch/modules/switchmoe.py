"""Switch-style top-1 mixture of experts as a Container (counterpart of
``puzzlelib_tpu/modules/switchmoe.py``).

Experts are ordinary modules appended like a Sequential's children; the
router's weight is the variable ``W`` of a ``MoEGate`` child named
``__gate__``, so parameter tables and optimizers reach it as they reach any
child.  The forward is the JAX package's ``_pureForward``: the routing of
``parallel.moe._dispatch``, the tokens scattered into each expert's
(capacity, features) buffer by the product ``bec,bd->ecd``, each expert run
on its buffer, and the outputs gathered back by ``bec,ecd->bd``, weighted
by the gate probability.  Both products are PyTorch's, as they are XLA's
in the JAX package.

The backward gives the JAX package's ``_vjp``, but does not run autograd
through the experts: on the card a Linear's product is the custom operator
``puzzlelib::matmul`` (kernel K1), which has no autograd formula.  So each
expert runs forward as the module it is (``expert(buffer)``, its product on
K1) and backward by its own ``backward``, with the scale and momentum of the
call; only the router (logits, softmax, combine weights, auxiliary loss) is
differentiated by autograd, over one recompute of its plain PyTorch ops, as
``backend/rnn.py`` differentiates the RNN.  The auxiliary loss enters with
the descent cotangent ``-auxWeight``, as in the JAX package: the module
protocol's gradients are descent-aligned, and optimizers add them.

Each expert reads its variables' own tensors.  So the layer trains also
under an optimizer's global state, where the variables are views of one
flat buffer; the JAX package's ``SwitchMoE`` reads root buffers there
(``fused.collectParamBuffers``) and fails.

Nothing in the routing reads a value back to the host, so ``FusedTrainer``
and ``FusedCalculator`` record the layer in their CUDA graphs.  The layer
carries a scheme (``insize``, ``capacityFactor``, ``auxWeight``) and its
experts in order (``getBlueprint``'s "graph"); a checkpoint holds the router
as the child ``__gate__``.

``distributedForward`` is the expert-parallel forward over a mesh axis
(``parallel.moe.routeExperts``, the routing of ``moeForward``): every rank
routes the whole batch and runs its E / N experts as the modules they are
(their products on K1 on the card), and the experts' outputs are gathered
from every rank before the combine.
"""

import numpy as np
import torch

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.variable import Variable
from puzzlelib_tpu_torch.modules.module import ModuleError, Module
from puzzlelib_tpu_torch.containers.container import Container, ContainerError
from puzzlelib_tpu_torch.parallel.moe import _dispatch, localExperts, routeExperts
from puzzlelib_tpu_torch.parallel._tree import asTensor


class MoEGate(Module):
    """Router weight holder: a leaf child of SwitchMoE, never called as a
    layer.  ``W`` (insize, nExperts) comes from the JAX package's sampler,
    ``np.random.RandomState(nExperts)``, so both packages hold the same
    gate."""

    def __init__(self, insize, nExperts, name=None):
        super().__init__(name)
        self.registerBlueprint(locals())

        rng = np.random.RandomState(nExperts)
        self.setVar("W", Variable(self.paramTensor((rng.randn(insize, nExperts) * 0.02).astype(np.float32),
                                                   (insize, nExperts))))

    def updateData(self, data):
        raise ModuleError("MoEGate is routed inside SwitchMoE, not called directly")

    def updateGrad(self, grad):
        raise ModuleError("MoEGate is routed inside SwitchMoE, not called directly")

    def dataShapeFrom(self, shape):
        return shape

    def gradShapeFrom(self, shape):
        return shape


class SwitchMoE(Container):
    def __init__(self, insize, capacityFactor=1.25, auxWeight=0.01, name=None):
        super().__init__(name)
        self.registerBlueprint(locals())

        self.insize = insize
        self.capacityFactor = capacityFactor
        self.auxWeight = auxWeight

        self.graph = []

        self.auxLoss = None
        self._routed = None

    # -- expert registry ---------------------------------------------------------

    def append(self, mod, acquire=True):
        super().append(mod, acquire)
        self.graph.append(mod)

        # the gate grows one column per expert: the child is made anew, in
        # the place of the first one among the children, as in the JAX package
        self.add_module("__gate__", MoEGate(self.insize, len(self.graph), name="__gate__"))

        return self

    @property
    def _gateMod(self):
        return self._modules["__gate__"]

    @property
    def gateVar(self):
        return self._gateMod.vars["W"]

    def getBlueprint(self):
        blueprint = super().getBlueprint()
        blueprint["graph"] = [mod.name for mod in self.graph]
        return blueprint

    @property
    def nExperts(self):
        return len(self.graph)

    def _capacity(self, tokens):
        return max(1, int(np.ceil(tokens * self.capacityFactor / self.nExperts)))

    # -- forward -----------------------------------------------------------------

    def updateData(self, data):
        capacity = self._capacity(data.shape[0])
        dispatch, combine, aux = _dispatch(self.gateVar.data, data, self.nExperts, capacity)

        expertIn = torch.einsum("bec,bd->ecd", dispatch, data)           # (E, C, d)
        outs = torch.stack([expert(expertIn[e]) for e, expert in enumerate(self.graph)])

        self.data = torch.einsum("bec,ecd->bd", combine, outs.to(data.dtype))
        self.auxLoss = aux
        self._routed = (dispatch, outs, capacity)

    # -- backward ----------------------------------------------------------------

    def _routerGrads(self, grad, withData):
        """(d expert outputs (E, C, d), d gate W, d input through the router
        or None): autograd over one recompute of the routing and the
        combine, the auxiliary loss with the cotangent -auxWeight."""
        _, outs, capacity = self._routed

        with torch.enable_grad():
            x = self.inData.detach().requires_grad_(withData)
            gateW = self.gateVar.data.detach().requires_grad_(True)
            outs = outs.detach().requires_grad_(True)

            _, combine, aux = _dispatch(gateW, x, self.nExperts, capacity)
            y = torch.einsum("bec,ecd->bd", combine, outs.to(x.dtype))

            gAux = torch.full((), -self.auxWeight, dtype=aux.dtype, device=aux.device)
            grads = torch.autograd.grad((y, aux), (outs, gateW, x) if withData else (outs, gateW),
                                        grad_outputs=(grad, gAux))

        return grads[0], grads[1], grads[2] if withData else None

    def backward(self, grad, updParamGrads=True, updGrad=True, scale=1.0, momentum=0.0):
        if not Config.disableDtypeShapeChecks:
            self.checkGradShape(self.acquireShapesFrom(grad))
            self.checkGradType(self.acquireDtypesFrom(grad))

        self.grad = None
        accumulate = updParamGrads and self.training

        dOuts, dGate, dx = self._routerGrads(grad, updGrad)

        for e, expert in enumerate(self.graph):
            expert.backward(dOuts[e].to(expert.data.dtype), updParamGrads=accumulate, updGrad=updGrad,
                            scale=scale, momentum=momentum)

        if accumulate:
            self._gateMod.foldParamGrad("W", dGate, scale, momentum)

        if updGrad:
            dispatch = self._routed[0]
            expertGrads = torch.stack([expert.grad for expert in self.graph]).to(dx.dtype)
            self.grad = dx + torch.einsum("bec,ecd->bd", dispatch, expertGrads)

    def updateGrad(self, grad):
        self.backward(grad, updParamGrads=False)

    def accGradParams(self, grad, scale=1.0, momentum=0.0):
        self.backward(grad, updGrad=False, scale=scale, momentum=momentum)

    # -- mesh path ---------------------------------------------------------------

    def distributedForward(self, x, mesh, expertAxis="expert"):
        """Expert-parallel forward over ``mesh``'s ``expertAxis``: each rank
        runs its E / N experts (each variable's own tensor, so also under
        an optimizer's global state); returns (output, auxLoss), whole on
        every rank.  A forward only, as the JAX package's."""
        x = asTensor(x)
        self.checkDataShape(tuple(x.shape))

        group = mesh.get_group(expertAxis)
        first, count = localExperts(self.nExperts, group, expertAxis)
        experts = self.graph[first:first + count]

        def runLocal(tokens):
            return torch.stack([expert(tokens[e]) for e, expert in enumerate(experts)])

        try:
            with torch.no_grad():
                return routeExperts(runLocal, self.nExperts, self.gateVar.data, x, group,
                                    self._capacity(x.shape[0]))
        finally:
            for expert in experts:
                expert.reset()

    # -- protocol ----------------------------------------------------------------

    def reset(self):
        super().reset()
        self.auxLoss = None
        self._routed = None

    def checkDataShape(self, shape):
        if len(shape) != 2:
            raise ModuleError("Data must be 2d (tokens, features)")

        if shape[1] != self.insize:
            raise ModuleError("Expected %d features, %d were given" % (self.insize, shape[1]))

        if not self.graph:
            raise ContainerError("%s has no experts" % self)

    def checkGradShape(self, shape):
        self.checkDataShape(shape)

    def dataShapeFrom(self, shape):
        return shape

    def gradShapeFrom(self, shape):
        return shape
