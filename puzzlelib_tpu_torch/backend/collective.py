"""Collectives over a ``torch.distributed`` group, with the arithmetic of the
JAX package's grid reducer (``puzzlelib_tpu/parallel/grid.py:167-183``): a
mean is an f32 sum times 1 / size, rounded back to the tensor's type, and a
broadcast copies the source rank's bits.

On NCCL the sum is issued as ``PREMUL_SUM`` by 1.0, which is the same sum bit
for bit (a product by 1.0 is exact): NCCL's in-place ``SUM`` over a group of
one rank is a no-op that leaves nothing in a CUDA graph, while ``PREMUL_SUM``
runs its kernel on any number of ranks, so a recorded step holds its
collective on one card as on several.  gloo has no ``PREMUL_SUM`` and takes
``SUM``.  A failed collective raises; nothing here falls back.

Model parallelism adds all-gather, reduce-scatter (an f32 sum, as the
all-reduce's), send and receive, each over the ranks of ``group`` in rank
order.  gloo takes all-reduce, broadcast, all-gather and reduce-scatter on
CUDA tensors; its send and receive are for host memory (a CUDA tensor's
send ends the sending process), so on gloo a CUDA tensor is sent and
received through a host copy (``_throughHost``, decided from the backend
and the tensor's device before the call).  The computation stays on the
card: only the transfer goes through the host.

Four ``torch.autograd.Function``s carry the shard boundaries of the
model-parallel functions, whose callers hold whole tensors, identical on
every rank, and differentiate a loss that every rank computes the same:

- ``takeShard``: this rank's block of a whole tensor; its backward gathers
  the blocks' gradients, so every rank gets the whole gradient;
- ``gatherShards``: the whole tensor from every rank's block; its backward
  takes this rank's block of the (identical) whole gradient.  An all-gather
  whose backward sums the ranks' gradients, as
  ``torch.distributed.nn.functional.all_gather``'s does, would give each
  rank N times the gradient of a loss they all compute;
- ``allGatherRegion`` and ``reduceScatterRegion``: the collectives inside an
  SPMD region, where each rank's cotangent differs, with JAX's transposes
  (``lax.all_gather``'s is ``psum_scatter``, and back).
"""

import torch
import torch.distributed as dist


def meshAxis(mesh, axis):
    """(the process group, this rank's index, the size) of ``mesh``'s axis."""
    group = mesh.get_group(axis)
    return group, dist.get_rank(group), dist.get_world_size(group)


def _sumOp(group):
    if dist.get_backend(group) == dist.Backend.NCCL:
        return dist._make_nccl_premul_sum(1.0)

    return dist.ReduceOp.SUM


def _throughHost(tensor, group):
    """True where ``group`` runs gloo and ``tensor`` is on a card: gloo's
    send and receive take host memory."""
    return tensor.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


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


def broadcastInPlace(tensor, group, src=0):
    """Rank ``src``'s ``tensor`` (its rank in ``group``) copied into every
    rank's, bit for bit (as bytes, whatever the type)."""
    if not tensor.is_contiguous():
        raise ValueError("broadcastInPlace takes a contiguous tensor, got strides %s" % (tensor.stride(), ))

    dist.broadcast(tensor.reshape(-1).view(torch.uint8), group=group, group_src=src)
    return tensor


def memoryFormat(tensor):
    """The memory format ``tensor`` is dense in: channels-last (2-d or 3-d)
    where it is so and not plainly contiguous, else contiguous."""
    for ndim, fmt in ((4, torch.channels_last), (5, torch.channels_last_3d)):
        if tensor.dim() == ndim and not tensor.is_contiguous() and tensor.is_contiguous(memory_format=fmt):
            return fmt

    return torch.contiguous_format


def blockOf(tensor, dim, group):
    """This rank's block of ``tensor`` along ``dim``, of 1 / size of it (a
    view); the dim must divide over the group."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if tensor.shape[dim] % size:
        raise ValueError("dim %d of %s does not divide over %d ranks" % (dim, tuple(tensor.shape), size))

    rows = tensor.shape[dim] // size
    return tensor.narrow(dim, rank * rows, rows)


def allGather(tensor, group, dim=0):
    """Every rank's ``tensor``, concatenated along ``dim`` in rank order, in
    the memory format of ``tensor`` (so a channels-last block gathers into a
    channels-last whole)."""
    size = dist.get_world_size(group)
    block = tensor.contiguous()

    # the blocks one after another along dim 0, as gloo and NCCL both take it
    out = torch.empty((size * block.shape[0], ) + tuple(block.shape[1:]), dtype=block.dtype, device=block.device)
    dist.all_gather_into_tensor(out, block, group=group)

    if dim != 0:
        out = torch.cat(out.chunk(size), dim=dim)

    return out.contiguous(memory_format=memoryFormat(tensor))


def reduceScatter(tensor, group, dim=0):
    """This rank's block along ``dim`` of the sum of every rank's ``tensor``:
    summed in f32, back in the tensor's type."""
    size = dist.get_world_size(group)
    if tensor.shape[dim] % size:
        raise ValueError("dim %d of %s does not divide over %d ranks" % (dim, tuple(tensor.shape), size))

    acc = tensor.movedim(dim, 0).float().contiguous()
    out = torch.empty((acc.shape[0] // size, ) + tuple(acc.shape[1:]), dtype=acc.dtype, device=acc.device)
    dist.reduce_scatter_tensor(out, acc, op=_sumOp(group), group=group)

    return out.to(tensor.dtype).movedim(0, dim)


def send(tensor, dst, group):
    """``tensor`` to rank ``dst`` of ``group``; returns when it is sent."""
    block = tensor.contiguous()
    dist.send(block.cpu() if _throughHost(block, group) else block, group=group, group_dst=dst)


def recv(tensor, src, group):
    """``tensor`` (contiguous) filled, in place, from rank ``src`` of
    ``group``."""
    if _throughHost(tensor, group):
        host = torch.empty(tensor.shape, dtype=tensor.dtype)
        dist.recv(host, group=group, group_src=src)
        tensor.copy_(host)
    else:
        dist.recv(tensor, group=group, group_src=src)

    return tensor


class _TakeShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group, dim):
        ctx.group, ctx.dim = group, dim
        return blockOf(tensor, dim, group).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return allGather(grad, ctx.group, ctx.dim), None, None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, group, dim):
        ctx.group, ctx.dim = group, dim
        return allGather(block, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return blockOf(grad, ctx.dim, ctx.group).contiguous(), None, None


class _AllGatherRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, group, dim):
        ctx.group, ctx.dim = group, dim
        return allGather(block, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return reduceScatter(grad, ctx.group, ctx.dim), None, None


class _ReduceScatterRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduceScatter(tensor, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return allGather(grad, ctx.group, ctx.dim), None, None


def takeShard(tensor, group, dim=0):
    """This rank's block of a whole ``tensor``; the backward all-gathers."""
    return _TakeShard.apply(tensor, group, dim)


def gatherShards(block, group, dim=0):
    """The whole tensor from every rank's ``block``; the backward takes this
    rank's block of the gradient."""
    return _GatherShards.apply(block, group, dim)


def allGatherRegion(block, group, dim=0):
    """All-gather inside an SPMD region; the backward reduce-scatters."""
    return _AllGatherRegion.apply(block, group, dim)


def reduceScatterRegion(tensor, group, dim=0):
    """Reduce-scatter (sum) inside an SPMD region; the backward
    all-gathers."""
    return _ReduceScatterRegion.apply(tensor, group, dim)
