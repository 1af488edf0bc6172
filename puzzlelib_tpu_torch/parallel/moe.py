"""Switch-style top-1 routing (counterpart of ``puzzlelib_tpu/parallel/moe.py``).

Top-1 gating builds a (tokens, experts, capacity) one-hot dispatch tensor;
``SwitchMoE`` scatters the tokens into the experts' buffers and gathers
them back with two products over it.  Nothing here reads a value back to
the host: the one-hots compare against ``arange``s of sizes known on the
host, so a CUDA graph can record the routing.

``moeForward``, which shards the experts over a mesh, is not ported yet.
"""

import torch


def stackExpertParams(paramsList):
    """Per-expert parameter lists stacked along a new leading expert axis:
    one tensor for each parameter position."""
    return [torch.stack(params) for params in zip(*paramsList)]


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
