"""Parallelism (counterpart of ``puzzlelib_tpu/parallel``).

Every distributed run is a grid of processes, one rank a process
(``runGrid``), each holding a ``torch.distributed`` ``DeviceMesh`` with
the JAX mesh's axis names; the JAX package's GSPMD and ``shard_map``
programs are explicit collectives here (``backend/collective.py``).

- ``grid``: data parallelism with the reference's API (``runGrid``,
  ``NodeInfo``; optimizers built with ``nodeinfo=``).
  ``fused.FusedStep(mesh=...)`` is the fused form: each rank of the data
  axis runs its own step on its shard of the global batch, and with
  ``stateShardings`` (``fused.tensorParallelSpecs``,
  ``fused.zeroOptimizerSpecs``) tensor parallelism and ZeRO-1 optimizer
  state sharding.
- ``pipeline``: the GPipe schedule over a stage axis (``stackStageParams``,
  ``pipelineForward``, ``pipelineGrad``); ``containers.Pipeline`` runs it
  over module stages.
- ``seqparallel``: Megatron-style sequence parallelism (``seqParallelMLP``).
- ``moe``: Switch top-1 expert parallelism (``stackExpertParams``,
  ``moeForward``; ``modules.SwitchMoE.distributedForward``).

The functions take whole tensors, identical on every rank of the axis, and
return whole tensors, identical on every rank; their gradients equal the
single-device gradients on every rank."""

from puzzlelib_tpu_torch.parallel.grid import runGrid, NodeInfo
from puzzlelib_tpu_torch.parallel.pipeline import stackStageParams, pipelineForward, pipelineGrad
from puzzlelib_tpu_torch.parallel.seqparallel import seqParallelMLP
from puzzlelib_tpu_torch.parallel.moe import stackExpertParams, moeForward
