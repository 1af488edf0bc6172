"""Embedding gather and its scatter-add backward (counterpart of
``puzzlelib_tpu/ops/embed.py``).

Negative indices are padding: their rows come out zero and add nothing to
the gradient.  The reference computes both outside Pallas, so here they are
the library's (``embedding``, ``index_put_``).
"""

import torch


def embed(indices, W):
    """W's rows at ``indices`` (any shape, int) -> indices.shape + (embsize, )."""
    out = torch.nn.functional.embedding(indices.clamp(min=0), W)
    return out.masked_fill((indices < 0)[..., None], 0)


def embedBackwardParams(indices, grad, wgrad, scale):
    """wgrad[indices] += grad * scale, in place, row by row; padding rows add
    nothing.  The rows are scaled in the gradient's type, as the reference
    scales them, and summed in f32 before one rounding to wgrad's type: the
    reference's scatter-add of a token repeated n times rounds n times in bf16
    instead.  The sum is ``index_put_`` with ``accumulate``, which on the
    card sorts the indices and adds each token's rows in one order, so the
    result repeats bit for bit (``index_add_`` adds with atomics there, and
    gave other bits at each call on an H100)."""
    index = indices.reshape(-1).long()
    rows = (grad * torch.tensor(scale, dtype=grad.dtype)).reshape(-1, grad.shape[-1]).float()

    # padding rows go to row 0 as zeros: no boolean indexing, which would
    # wait for the device
    total = torch.zeros(wgrad.shape, dtype=torch.float32, device=wgrad.device)
    total.index_put_((index.clamp(min=0), ), rows * (index >= 0)[:, None], accumulate=True)

    return wgrad.copy_(wgrad.float() + total)
