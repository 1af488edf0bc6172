"""Pipeline container (counterpart of ``puzzlelib_tpu/containers/pipeline.py``):
a Sequential of structurally equal stages that also runs the GPipe schedule
over a mesh "stage" axis.

On one device it is a Sequential: its forward and backward are the
Sequential's.  The stages' weights come as lists in one order
(``checkStageStructure``, ``stackedStageParams``), stage 0 as a function of
a weight list (``_stageApply``, ``fused.functionalize``), and stacked
gradients fold back into each stage's variables (``foldStageGrads``).

On a mesh (one process a rank, a ``DeviceMesh`` with a stage axis of as
many ranks as stages) rank s runs its own stage ``self.graph[s]`` through
the module protocol, on the schedule of ``parallel/pipeline.py``: the
JAX package lifts the stages through ``functionalize`` into its autodiff,
but the port's ``functionalize`` is a forward only and a Linear's product
on the card (``puzzlelib::matmul``, K1) has no autograd formula.  So:

- ``distributedForward`` runs the stage's forward on each microbatch in
  turn and hands the result to the next rank; the last rank's outputs are
  broadcast, whole, to every rank;
- ``distributedGrad`` runs every forward first, then each microbatch's
  backward in reverse order.  A module keeps only its last forward's state,
  so before each backward but the first (the last microbatch's, whose
  forward the stage still holds) the stage runs that microbatch's forward
  again: GPipe's recomputation.  A step thus runs 2 * microbatches - 1
  forwards of each stage.  The parameter gradients sum over the
  microbatches (the first backward writes them, the later ones add with
  momentum 1) in the stage's own gradient buffers, whose contents are put
  back afterwards.  Only the last rank differentiates ``lossFn(out,
  target)``, by autograd on a leaf of its whole output.  The gradient is
  that of ``lossFn`` alone, as the JAX package's: a ``SwitchMoE`` in a stage
  runs its backward with its auxiliary loss weight at 0 (the functionalized
  JAX stage drops the auxiliary loss).

The gradients come back as loss gradients, the ascent direction, stacked in
``stackedStageParams`` order, whole on every rank, so that
``foldStageGrads`` (which negates) and an optimizer's ``update`` leave every
rank with the whole trained pipe, as the JAX mesh loop does.
"""

import contextlib

import torch

from puzzlelib_tpu_torch.backend import collective
from puzzlelib_tpu_torch.containers.container import ContainerError
from puzzlelib_tpu_torch.containers.sequential import Sequential
from puzzlelib_tpu_torch.ops import elementwise as ew
from puzzlelib_tpu_torch.parallel import pipeline as schedule
from puzzlelib_tpu_torch.parallel._tree import asTensor


class Pipeline(Sequential):
    def checkStageStructure(self):
        """All stages must share parameter structure (shapes, types and
        order): the stacked-weights regime GPipe requires."""
        from puzzlelib_tpu_torch.fused import paramList

        shapes = None
        for index, stage in enumerate(self.graph):
            cur = [(tuple(param.shape), str(param.dtype)) for param in paramList(stage)]

            if shapes is None:
                shapes = cur
            elif cur != shapes:
                raise ContainerError("%s: stage %d parameter structure %s differs from stage 0 %s" %
                                     (self, index, cur, shapes))

    def stackedStageParams(self):
        """Per-stage weight lists stacked along a new leading stage axis: one
        tensor for each parameter position."""
        from puzzlelib_tpu_torch.fused import paramList

        self.checkStageStructure()
        return [torch.stack(params) for params in zip(*(paramList(stage) for stage in self.graph))]

    def _stageApply(self):
        """``functionalize(stage 0)``'s apply, cached while the stage count
        stays."""
        apply = getattr(self, "_applyCache", None)

        if apply is None or self._applyCacheLen != len(self.graph):
            from puzzlelib_tpu_torch.fused import functionalize

            apply, _ = functionalize(self.graph[0])
            self._applyCache, self._applyCacheLen = apply, len(self.graph)

        return apply

    def _meshStage(self, x, mesh, stageAxis, microbatches):
        """(the stage axis's group, this rank's stage index, the stage
        count, the microbatches of ``x``, this rank's stage module)."""
        group, stage, nStages = collective.meshAxis(mesh, stageAxis)
        if nStages != len(self.graph):
            raise ContainerError("%s has %d stages, the '%s' axis %d ranks" % (self, len(self.graph), stageAxis,
                                                                              nStages))

        self.checkStageStructure()
        mb = schedule.splitMicro(asTensor(x), microbatches or len(self.graph))

        stageMod = self.graph[stage]
        schedule.checkStageShape(mb.shape[1:], mb.dtype, stageMod.dataShapeFrom(tuple(mb.shape[1:])), mb.dtype)
        return group, stage, nStages, mb, stageMod

    def distributedForward(self, x, mesh, stageAxis="stage", microbatches=None):
        """One GPipe forward over the mesh: x (batch, ...) -> the output,
        whole on every rank.  ``microbatches`` defaults to the stage count;
        the batch must divide evenly into microbatches."""
        group, stage, nStages, mb, stageMod = self._meshStage(x, mesh, stageAxis, microbatches)

        try:
            with torch.no_grad():
                pairs = schedule.forwardSchedule(lambda inp: stageMod(inp).clone(), mb, group, stage, nStages)
        finally:
            stageMod.reset()

        return schedule.gatherOutputs([y for _, y in pairs], mb, group, stage, nStages)

    def distributedGrad(self, lossFn, x, target, mesh, stageAxis="stage", microbatches=None):
        """One GPipe forward and backward over the mesh: returns (loss, the
        stacked loss gradients), the loss an f32 0-d tensor.

        ``lossFn(out, target) -> scalar`` is a torch function of the whole
        output; the gradients come back stacked along the stage axis, in
        ``stackedStageParams()`` order."""
        group, stage, nStages, mb, stageMod = self._meshStage(x, mesh, stageAxis, microbatches)

        variables = self._stageVars(stageMod)
        if any(var.grad is None for var in variables):
            raise ContainerError("%s: distributedGrad sums the microbatches' gradients in the stage's gradient "
                                 "buffers, which a variable without one lacks (Config.globalEvalMode?)" % self)

        saved = [var.grad.clone() for var in variables]
        try:
            with torch.no_grad(), withoutAuxLoss(stageMod):
                pairs = schedule.forwardSchedule(lambda inp: stageMod(inp).clone(), mb, group, stage, nStages)
                loss, dOut = schedule.lossAndGrad(lossFn, [y for _, y in pairs], asTensor(target),
                                                  group, stage, nStages)

                rows, last = mb.shape[1], len(pairs) - 1
                for m in reversed(range(len(pairs))):
                    inp, y = pairs[m]
                    # the module protocol's gradients are descent-aligned
                    grad = -dOut[m * rows:(m + 1) * rows] if dOut is not None else \
                        collective.recv(torch.empty_like(y), stage + 1, group)

                    if m != last:
                        stageMod(inp)

                    stageMod.backward(grad, updGrad=stage > 0, scale=1.0, momentum=0.0 if m == last else 1.0)
                    if stage > 0:
                        collective.send(stageMod.grad, stage - 1, group)

                grads = [-var.grad for var in variables]

        finally:
            for var, value in zip(variables, saved):
                var.grad.copy_(value)

            stageMod.reset()

        return loss, schedule.gatherStacked(grads, group)

    @staticmethod
    def _stageVars(stage):
        """Variables of one stage in ``collectParamBuffers`` order."""
        from puzzlelib_tpu_torch.fused import stageVars
        return stageVars(stage)

    def foldStageGrads(self, stackedGrads, scale=1.0, momentum=0.0):
        """Scatter stacked stage gradients back into each stage's variables:
        grad = -scale * g + momentum * grad, in place.  ``stackedGrads`` are
        loss gradients (the ascent direction, ``stackedStageParams``
        order); the module protocol keeps descent-aligned gradients, which
        optimizers add, so the fold negates."""
        for index, stage in enumerate(self.graph):
            for var, g in zip(self._stageVars(stage), [stacked[index] for stacked in stackedGrads]):
                if var.grad is not None:
                    ew.add_(var.grad, g.reshape(var.grad.shape).to(var.grad.dtype), -scale, var.grad, momentum)


@contextlib.contextmanager
def withoutAuxLoss(stage):
    """Every ``SwitchMoE`` of ``stage`` with its auxiliary loss weight at 0,
    put back on leaving."""
    from puzzlelib_tpu_torch.modules.switchmoe import SwitchMoE

    layers = [mod for mod in stage.modules() if isinstance(mod, SwitchMoE)]
    weights = [layer.auxWeight for layer in layers]

    try:
        for layer in layers:
            layer.auxWeight = 0.0
        yield
    finally:
        for layer, weight in zip(layers, weights):
            layer.auxWeight = weight
