"""Parallelism (counterpart of ``puzzlelib_tpu/parallel``).

- ``grid``: data parallelism with the reference's API, one process a node
  over ``torch.distributed`` (``runGrid``, ``NodeInfo``; optimizers built with
  ``nodeinfo=``).  ``fused.FusedStep(mesh=...)`` is the fused form of data
  parallelism: each rank of a ``DeviceMesh``'s data axis runs its own step
  on its shard of the global batch.
- ``moe``: what one device runs of expert parallelism (``stackExpertParams``).

Not ported yet (model parallelism): ``moeForward`` over a mesh, the GPipe
schedule (``pipeline``), sequence parallelism (``seqparallel``) and the
sharding specs of ``FusedStep`` (``stateShardings``)."""

from puzzlelib_tpu_torch.parallel.grid import runGrid, NodeInfo
from puzzlelib_tpu_torch.parallel.moe import stackExpertParams
