"""Scaled-dot-product attention (counterpart of
``puzzlelib_tpu/ops/attention.py``).

``attention`` is the composed attention in PyTorch, the counterpart of the
reference's XLA route and what ``attentionAlgo = "xla"`` names here: f32
scores, an f32 softmax, the probabilities cast to the input's type before the
product with v.  ``mhaForward`` is the whole multi-head block; its core is
``attention`` or, under "flash", kernel K4 (``ops.hopper.flash``).  Its four
projections are ``torch.matmul`` with f32 accumulation, as the reference
computes them with ``einsum`` outside any Pallas kernel.  The backward, and
the measured "auto" choice (``measureAttnChoice``), come with the training
slice.
"""

import math

import torch

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.ops.hopper import flash as _flash


def attention(q, k, v, causal=False):
    """q, k, v (batch, heads, seq, d) -> (batch, heads, seqQ, d) in q's type."""
    seqQ, seqK, d = q.shape[2], k.shape[2], q.shape[3]

    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))

    if causal:
        mask = torch.ones((seqQ, seqK), dtype=torch.bool, device=q.device).tril(diagonal=seqK - seqQ)
        scores = scores.masked_fill(~mask, float("-inf"))

    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(q.dtype), v)


def resolveAlgo(algo, seq, dtype, device):
    """The attention core, "xla" or "flash", for ``algo`` (a value of
    ``Config.attentionAlgo``): "xla" and "flash" force it; "auto" keeps the
    reference's structural prior, flash for bf16 on the card at seq >= 1024
    and "xla" otherwise."""
    if algo not in Config.ATTENTION_ALGOS:
        raise Config.ConfigError("Unknown attention algo %r (expected one of %s)" %
                                 (algo, ", ".join(Config.ATTENTION_ALGOS)))

    if algo != "auto":
        return algo

    return "flash" if torch.device(device).type == "cuda" and dtype == torch.bfloat16 and seq >= 1024 else "xla"


def mhaForward(x, wq, wk, wv, wo, bq, bk, bv, bo, nheads, causal=False, algo="xla"):
    """The multi-head attention block: (batch, seq, emb) -> (batch, seq, emb).
    Weights are (emb, emb), biases (emb, ) or None; heads split the embedding."""
    if algo not in ("xla", "flash"):
        raise Config.ConfigError("mhaForward takes algo 'xla' or 'flash', got %r" % algo)

    batch, seq, emb = x.shape
    hdim = emb // nheads

    def proj(w, b):
        y = torch.matmul(x, w)
        if b is not None:
            y = y + b
        return y.reshape(batch, seq, nheads, hdim).transpose(1, 2)

    q, k, v = proj(wq, bq), proj(wk, bk), proj(wv, bv)

    if algo == "flash":
        out, _ = _flash.flash(q, k, v, causal)
    else:
        out = attention(q, k, v, causal)

    y = torch.matmul(out.transpose(1, 2).reshape(batch, seq, emb), wo)
    return y if bo is None else y + bo
