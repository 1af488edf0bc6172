"""Expert parallelism: Switch-style top-1 routing (counterpart of
``puzzlelib_tpu/parallel/moe.py``).

Top-1 gating builds a (tokens, experts, capacity) one-hot dispatch tensor;
two products over it scatter the tokens into the experts' buffers and
gather them back.  Nothing here reads a value back to the host: the
one-hots compare against ``arange``s of sizes known on the host, so a CUDA
graph can record the routing (``SwitchMoE``'s forward).

``moeForward`` shards the experts over a mesh axis, as the JAX package's
``shard_map`` does: every rank routes the whole batch (its inputs are
whole and identical on every rank), takes its E / N experts' parameters
and its E / N slices of the dispatched (E, C, d) tokens
(``collective.takeShard``), runs its experts, and gathers the (E, C, d)
outputs from every rank (``collective.gatherShards``) before the combine
product.  So the output and the auxiliary loss are whole on every rank, and
autograd gives every rank the whole gradient of a loss they all compute
(the shard boundaries' backwards gather, or take this rank's slice).
``SwitchMoE.distributedForward`` routes the same way through the layer's
own expert modules (``routeExperts``).
"""

import numpy as np
import torch

from puzzlelib_tpu_torch.backend import collective
from puzzlelib_tpu_torch.parallel._tree import asTensor, stackTrees, treeLeaves, treeMap


def stackExpertParams(paramsList):
    """Per-expert parameter trees (dicts, lists or tuples of tensors)
    stacked along a new leading expert axis: one tensor for each leaf
    position."""
    return stackTrees(paramsList)


def _oneHot(index, size, dtype):
    """(..., size) rows, 1 at ``index`` and 0 elsewhere; an index outside
    [0, size) gives a row of zeros, as ``jax.nn.one_hot`` does."""
    return (index.unsqueeze(-1) == torch.arange(size, device=index.device)).to(dtype)


def _dispatch(gateW, x, nExperts, capacity):
    """Top-1 routing: returns (dispatch (B, E, C), combine (B, E, C), auxLoss).

    Each token goes to the expert of its largest gate probability (the first
    of equal ones), at the next free slot of that expert's buffer; a token
    past ``capacity`` is dropped (its rows stay zero).  ``combine`` is
    ``dispatch`` times the token's gate probability, and ``auxLoss`` the
    Switch load-balancing loss E * sum_e fraction_e * meanProb_e."""
    logits = x @ gateW                                        # (B, E)
    probs = torch.softmax(logits, dim=-1)

    expert = torch.argmax(probs, dim=-1)                      # (B, )
    gate = torch.gather(probs, 1, expert[:, None])[:, 0]

    onehot = _oneHot(expert, nExperts, x.dtype)               # (B, E)

    # position of each token within its expert's buffer; drop beyond capacity
    position = (torch.cumsum(onehot, dim=0) - 1.0) * onehot   # (B, E)
    keep = (position < capacity).to(x.dtype)

    dispatch = onehot[:, :, None] * keep[:, :, None] * _oneHot(position.to(torch.int64), capacity, x.dtype)

    combine = dispatch * gate[:, None, None]

    fraction = torch.mean(onehot, dim=0)
    meanProb = torch.mean(probs, dim=0)
    auxLoss = nExperts * torch.sum(fraction * meanProb)

    return dispatch, combine, auxLoss


def localExperts(nExperts, group, axis):
    """(the first of this rank's experts, how many it runs): E / N each."""
    size, rank = torch.distributed.get_world_size(group), torch.distributed.get_rank(group)
    if nExperts % size:
        raise ValueError("%d experts not divisible over %d '%s' shards" % (nExperts, size, axis))

    return rank * (nExperts // size), nExperts // size


def routeExperts(runLocal, nExperts, gateW, x, group, capacity):
    """(out, auxLoss) of top-1 routing where this rank runs its share of the
    experts: ``runLocal(tokens (E / N, C, d)) -> (E / N, C, d)``.  The gate
    ``gateW`` (d, E) must have a column for each expert."""
    if gateW.shape[-1] != nExperts:
        raise ValueError("Gate width %d does not match expert count %d" % (gateW.shape[-1], nExperts))

    dispatch, combine, auxLoss = _dispatch(gateW, x, nExperts, capacity)

    expertIn = torch.einsum("bec,bd->ecd", dispatch, x)                   # (E, C, d)
    expertOut = collective.gatherShards(runLocal(collective.takeShard(expertIn, group)), group)

    return torch.einsum("bec,ecd->bd", combine, expertOut.to(x.dtype)), auxLoss


def moeForward(expertFn, stackedParams, gateW, x, mesh, expertAxis="expert", capacityFactor=1.25):
    """(B, d) -> (B, d) through experts sharded over ``expertAxis``; returns
    (out, auxLoss), whole on every rank.

    ``expertFn(params, tokens) -> tokens`` maps (C, d) -> (C, d) for one
    expert, in torch operations; ``stackedParams`` leaves have the expert
    count as their leading dim.  Tokens overflowing an expert's capacity
    ``ceil(capacityFactor * B / E)`` are dropped (standard Switch
    behavior): their output is zero."""
    nExperts = treeLeaves(stackedParams)[0].shape[0]
    x, gateW = asTensor(x), asTensor(gateW)

    group = mesh.get_group(expertAxis)
    localExperts(nExperts, group, expertAxis)
    capacity = int(np.ceil(capacityFactor * x.shape[0] / nExperts))

    local = treeMap(lambda leaf: collective.takeShard(leaf, group), stackedParams)

    def runLocal(tokens):
        return torch.stack([expertFn(treeMap(lambda leaf: leaf[e], local), tokens[e])
                            for e in range(tokens.shape[0])])

    return routeExperts(runLocal, nExperts, gateW, x, group, capacity)
