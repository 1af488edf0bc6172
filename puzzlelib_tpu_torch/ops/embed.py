"""Embedding gather (counterpart of ``puzzlelib_tpu/ops/embed.py``).

Negative indices are padding: their rows come out zero.  The reference
computes the gather outside Pallas, so here it is the library's.  The
scatter-add backward comes with the training slice.
"""

import torch


def embed(indices, W):
    """W's rows at ``indices`` (any shape, int) -> indices.shape + (embsize, )."""
    out = torch.nn.functional.embedding(indices.clamp(min=0), W)
    return out.masked_fill((indices < 0)[..., None], 0)
