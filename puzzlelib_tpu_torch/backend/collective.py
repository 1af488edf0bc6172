"""Collectives over a ``torch.distributed`` group, with the arithmetic of the
JAX package's grid reducer (``puzzlelib_tpu/parallel/grid.py:167-183``): a
mean is an f32 sum times 1 / size, rounded back to the tensor's type, and a
broadcast copies rank 0's bits.

On NCCL the sum is issued as ``PREMUL_SUM`` by 1.0, which is the same sum bit
for bit (a product by 1.0 is exact): NCCL's in-place ``SUM`` over a group of
one rank is a no-op that leaves nothing in a CUDA graph, while ``PREMUL_SUM``
runs its kernel on any number of ranks, so a recorded step holds its
collective on one card as on several.  gloo has no ``PREMUL_SUM`` and takes
``SUM``.  A failed collective raises; nothing here falls back.
"""

import torch
import torch.distributed as dist


def _sumOp(group):
    if dist.get_backend(group) == dist.Backend.NCCL:
        return dist._make_nccl_premul_sum(1.0)

    return dist.ReduceOp.SUM


def sumInPlace(tensor, group):
    """``tensor`` summed over ``group``, in place."""
    dist.all_reduce(tensor, op=_sumOp(group), group=group)
    return tensor


def meanInPlace(tensor, group):
    """``tensor`` replaced by its mean over ``group``: the sum in f32 (through
    an f32 copy for another type), times 1 / size, back in its type."""
    acc = tensor if tensor.dtype == torch.float32 else tensor.float()

    sumInPlace(acc, group)
    acc.mul_(1.0 / dist.get_world_size(group))

    if acc is not tensor:
        tensor.copy_(acc)

    return tensor


def broadcastInPlace(tensor, group):
    """Rank 0's ``tensor`` copied into every rank's, bit for bit (as bytes,
    whatever the type)."""
    if not tensor.is_contiguous():
        raise ValueError("broadcastInPlace takes a contiguous tensor, got strides %s" % (tensor.stride(), ))

    dist.broadcast(tensor.reshape(-1).view(torch.uint8), group=group, group_src=0)
    return tensor
