"""Pipeline container (counterpart of ``puzzlelib_tpu/containers/pipeline.py``):
a Sequential of structurally equal stages.

On one device it is a Sequential: its forward and backward are the
Sequential's.  What the GPipe schedule needs of it is here too: the stages'
weights as lists in one order (``checkStageStructure``,
``stackedStageParams``), one stage as a function of a weight list
(``_stageApply``, ``fused.functionalize`` of stage 0) and the fold of
stacked gradients back into each stage's variables (``foldStageGrads``).
The schedule itself, ``distributedForward`` and ``distributedGrad``, needs
a mesh, which the port does not have yet.
"""

import torch

from puzzlelib_tpu_torch.containers.container import ContainerError
from puzzlelib_tpu_torch.containers.sequential import Sequential
from puzzlelib_tpu_torch.ops import elementwise as ew


_MESH = "a mesh, which the port does not have yet (ROADMAP Queue 1, item 4)"


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

    def distributedForward(self, x, mesh, stageAxis="stage", microbatches=None):
        raise NotImplementedError("Pipeline.distributedForward runs the GPipe schedule over %s" % _MESH)

    def distributedGrad(self, lossFn, x, target, mesh, stageAxis="stage", microbatches=None):
        raise NotImplementedError("Pipeline.distributedGrad runs the GPipe schedule over %s" % _MESH)

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
