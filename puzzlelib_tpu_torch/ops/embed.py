"""Embedding gather and its scatter-add backward (counterpart of
``puzzlelib_tpu/ops/embed.py``).

Negative indices are padding: their rows come out zero and add nothing to
the gradient.  The reference computes both outside Pallas, so here they are
the library's (``embedding``, ``index_add_``).
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
    instead (``index_add_`` would too, in an order that varies from run to
    run)."""
    index = indices.reshape(-1).long()
    rows = (grad * torch.tensor(scale, dtype=grad.dtype)).reshape(-1, grad.shape[-1]).float()

    # padding rows go to row 0 as zeros: no boolean indexing, which would
    # wait for the device
    total = torch.zeros(wgrad.shape, dtype=torch.float32, device=wgrad.device)
    total.index_add_(0, index.clamp(min=0), rows * (index >= 0)[:, None])

    return wgrad.copy_(wgrad.float() + total)
