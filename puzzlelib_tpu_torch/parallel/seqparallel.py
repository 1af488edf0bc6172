"""Sequence parallelism (counterpart of
``puzzlelib_tpu/parallel/seqparallel.py``): activations sharded along the
token dim between tensor-parallel regions (Megatron-SP).

Between the products of a tensor-parallel MLP the activations live sharded
along the token dim, and the region is entered with an all-gather and left
with a reduce-scatter.  The body here is the JAX package's, as collectives
of ``backend/collective.py`` over the ranks of the mesh axis, with JAX's
transposes for autograd (``allGatherRegion``, ``reduceScatterRegion``).

The JAX function takes and returns global arrays, which its mesh holds
sharded; the port's ranks hold whole tensors, identical on every rank.  So
each rank takes its token shard of ``x`` and its column and row blocks of
``w1`` and ``w2`` (``collective.takeShard``, whose backward gathers the
gradients), and the sharded output is gathered whole
(``collective.gatherShards``): three collectives, the body's two and the
closing gather, which the JAX package leaves to its caller's sharding.
"""

import torch
import torch.nn.functional as F

from puzzlelib_tpu_torch.backend import collective
from puzzlelib_tpu_torch.parallel._tree import asTensor


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def seqParallelMLP(x, w1, w2, mesh, axis="model", activation=gelu):
    """activation(x @ w1) @ w2 with sequence-sharded activations and
    tensor-parallel weights; x (B, d), w1 (d, f), w2 (f, d), all whole.

    Per rank: all-gather the token shards -> the local column block of w1
    -> activation -> the local row block of w2 (partial sums) ->
    reduce-scatter back to token shards -> gathered whole.  The products are
    ``torch.matmul``, as the JAX body's are XLA dots."""
    x, w1, w2 = asTensor(x), asTensor(w1), asTensor(w2)
    group, _, nShards = collective.meshAxis(mesh, axis)

    if x.shape[0] % nShards != 0:
        raise ValueError("Token dim %d not divisible by %d '%s' shards" % (x.shape[0], nShards, axis))
    if w1.shape[1] % nShards != 0 or w2.shape[0] % nShards != 0:
        raise ValueError("Hidden dim %d not divisible by %d '%s' shards" % (w1.shape[1], nShards, axis))

    xl = collective.takeShard(x, group, 0)
    w1l, w2l = collective.takeShard(w1, group, 1), collective.takeShard(w2, group, 0)

    xg = collective.allGatherRegion(xl, group, 0)                      # (B, d) enter TP
    h = activation(torch.matmul(xg, w1l))                              # (B, f/N) local
    partial = torch.matmul(h, w2l)                                     # (B, d) partial
    out = collective.reduceScatterRegion(partial, group, 0)            # (B/N, d)

    return collective.gatherShards(out, group, 0)
