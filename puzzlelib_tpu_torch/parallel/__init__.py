"""Parallelism (counterpart of ``puzzlelib_tpu/parallel``): what one
device runs of it.  The mesh paths (``moeForward``, the GPipe schedule,
sequence parallelism, the grid) are not ported yet."""

from puzzlelib_tpu_torch.parallel.moe import stackExpertParams
