"""Scaled-dot-product attention (counterpart of
``puzzlelib_tpu/ops/attention.py``).

``attention`` is the composed attention in PyTorch, the counterpart of the
reference's XLA route and what ``attentionAlgo = "xla"`` names here: f32
scores, an f32 softmax, the probabilities cast to the input's type before the
product with v; ``attentionBackward`` is its VJP.  ``mhaForward`` is the
whole multi-head block and ``mhaBackward`` its VJP with respect to the input
and every weight and bias; their core is ``attention`` or, under "flash",
kernels K4 (forward) and K5a / K5b (backward) of ``ops.hopper.flash``.  The
four projections and their backward are ``torch.matmul`` with f32
accumulation, as the reference leaves them to ``einsum`` outside any Pallas
kernel.

``measureAttnChoice`` races the two cores on a training step's attention
(forward and the gradient with respect to q, k and v) at one signature and
records the faster in ``_attnChoice``, keyed by ``_signature`` as the
reference keys it (``attention.py:60-61``); ``resolveAlgo`` reads it under
"auto".
"""

import math

import torch

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.backend.device import getDevice
from puzzlelib_tpu_torch.ops.hopper import flash as _flash
from puzzlelib_tpu_torch.tools import timing


def attention(q, k, v, causal=False):
    """q, k, v (batch, heads, seq, d) -> (batch, heads, seqQ, d) in q's type."""
    seqQ, seqK, d = q.shape[2], k.shape[2], q.shape[3]

    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))

    if causal:
        mask = torch.ones((seqQ, seqK), dtype=torch.bool, device=q.device).tril(diagonal=seqK - seqQ)
        scores = scores.masked_fill(~mask, float("-inf"))

    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(q.dtype), v)


def attentionBackward(q, k, v, grad, causal=False):
    """The VJP of ``attention`` with respect to (q, k, v): the f32
    probabilities recomputed, the softmax backward in f32, the products in
    f32 from the operands' values, and the gradients in the inputs' type."""
    seqQ, seqK, d = q.shape[2], k.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(d)
    q32, k32, v32, g32 = q.float(), k.float(), v.float(), grad.float()

    scores = torch.matmul(q32, k32.transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones((seqQ, seqK), dtype=torch.bool, device=q.device).tril(diagonal=seqK - seqQ)
        scores = scores.masked_fill(~mask, float("-inf"))

    probs = torch.softmax(scores, dim=-1)

    dv = torch.matmul(probs.to(q.dtype).float().transpose(-1, -2), g32)
    dprobs = torch.matmul(g32, v32.transpose(-1, -2))
    dscores = probs * (dprobs - (dprobs * probs).sum(dim=-1, keepdim=True)) * scale

    dq = torch.matmul(dscores, k32)
    dk = torch.matmul(dscores.transpose(-1, -2), q32)

    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# _signature -> "flash" or "xla", filled by measureAttnChoice; the race's
# times in ms beside them (flash, composed)
_attnChoice = {}
_attnMs = {}

# the race's margin: flash only below 0.97x the composed route (attention.py:141)
MARGIN = 0.97


def _signature(batch, nheads, seq, hdim, causal, dtype):
    return (batch, nheads, seq, hdim, bool(causal), str(dtype).replace("torch.", ""))


def resolveAlgo(algo, batch, nheads, seq, hdim, causal, dtype, device):
    """The attention core, "xla" or "flash", for ``algo`` (a value of
    ``Config.attentionAlgo``) at this signature: "xla" and "flash" force
    it; "auto" takes the measured choice (``_attnChoice``) and, for an
    unmeasured signature, the reference's structural prior: flash for bf16
    on the card at seq >= 1024, "xla" otherwise.  Off the card or off bf16
    "auto" is "xla"."""
    if algo not in Config.ATTENTION_ALGOS:
        raise Config.ConfigError("Unknown attention algo %r (expected one of %s)" %
                                 (algo, ", ".join(Config.ATTENTION_ALGOS)))

    if algo != "auto":
        return algo

    if torch.device(device).type != "cuda" or dtype != torch.bfloat16:
        return "xla"

    choice = _attnChoice.get(_signature(batch, nheads, seq, hdim, causal, dtype))
    if choice is not None:
        return choice

    return "flash" if seq >= 1024 else "xla"


def measureAttnChoice(batch, nheads, seq, hdim, causal=False, dtype=torch.bfloat16, reps=10, k=3):
    """Race "flash" (K4, then K5a / K5b) against "xla" (``attention``, then
    ``attentionBackward``) on a training step's attention at this signature:
    the forward and the gradient with respect to q, k and v, on the same
    seeded operands, in ``k`` alternating turns of ``reps`` calls, the least
    turn of each.  Records "flash" only below ``MARGIN`` times the composed
    route (``attention.py:93-147``).  Returns (choice, flash ms, composed
    ms); None on the CPU and where the flash kernels do not take the
    signature (not bf16, a head dim off ``flash.HEAD_DIMS``), recording
    nothing.  A race that fails raises."""
    device = getDevice()
    if dtype != torch.bfloat16 or hdim not in _flash.HEAD_DIMS or not timing.raceable(device):
        return None

    gen = torch.Generator(device=device).manual_seed(3)
    q, k_, v, dOut = [(torch.randn((batch, nheads, seq, hdim), generator=gen, device=device) * 0.5).to(dtype)
                      for _ in range(4)]

    def flashStep():
        out, lse = _flash.flash(q, k_, v, causal)
        return _flash.backward(q, k_, v, out, lse, dOut, causal)

    def composedStep():
        attention(q, k_, v, causal)
        return attentionBackward(q, k_, v, dOut, causal)

    times = timing.race({"flash": flashStep, "xla": composedStep}, reps, k)
    choice = "flash" if timing.handWins(times["flash"], times["xla"], MARGIN) else "xla"

    key = _signature(batch, nheads, seq, hdim, causal, dtype)
    _attnMs[key] = (times["flash"], times["xla"])
    Config.recordChoice(_attnChoice, key, choice)
    return choice, times["flash"], times["xla"]


def mhaForward(x, wq, wk, wv, wo, bq, bk, bv, bo, nheads, causal=False, algo="xla", save=False):
    """The multi-head attention block: (batch, seq, emb) -> (batch, seq, emb).
    Weights are (emb, emb), biases (emb, ) or None; heads split the embedding.

    With ``save``, returns (y, saved): what ``mhaBackward`` needs of this
    forward, so that the backward launches no forward kernel again: the
    projected q, k, v (batch, heads, seq, d) as the core read them (under
    "flash" the contiguous copies that K4 read), the core's output and its
    lse (None under "xla"), and the merged heads that went into Wo."""
    if algo not in ("xla", "flash"):
        raise Config.ConfigError("mhaForward takes algo 'xla' or 'flash', got %r" % algo)

    batch, seq, emb = x.shape
    hdim = emb // nheads

    def proj(w, b):
        y = torch.matmul(x, w)
        if b is not None:
            y = y + b
        y = y.reshape(batch, seq, nheads, hdim).transpose(1, 2)
        # the flash kernels read contiguous (batch * heads, seq, d) rows:
        # this copy is the one they read, forward and backward
        return y.contiguous() if algo == "flash" else y

    q, k, v = proj(wq, bq), proj(wk, bk), proj(wv, bv)

    lse = None
    if algo == "flash":
        out, lse = _flash.flash(q, k, v, causal)
    else:
        out = attention(q, k, v, causal)

    merged = out.transpose(1, 2).reshape(batch, seq, emb)
    y = torch.matmul(merged, wo)
    y = y if bo is None else y + bo

    if not save:
        return y

    return y, {"q": q, "k": k, "v": v, "out": out, "lse": lse, "merged": merged}


def mhaBackward(x, wq, wk, wv, wo, bq, bk, bv, bo, grad, nheads, causal=False, algo="xla", saved=None):
    """The VJP of ``mhaForward`` with respect to the input and every weight
    and bias: (dx, dWq, dWk, dWv, dWo) and, with biases, (dbq, dbk, dbv,
    dbo) after them.  ``saved`` is what ``mhaForward(..., save=True)``
    returned; without it the forward is run again here.  Under "flash" the
    core's backward is kernels K5a and K5b (``flash.backward``), under "xla"
    ``attentionBackward``.  Weight gradients come in the weights' type, dx in
    x's."""
    if algo not in ("xla", "flash"):
        raise Config.ConfigError("mhaBackward takes algo 'xla' or 'flash', got %r" % algo)

    if saved is None or (algo == "flash" and saved["lse"] is None):
        _, saved = mhaForward(x, wq, wk, wv, wo, bq, bk, bv, bo, nheads, causal, algo, save=True)

    batch, seq, emb = x.shape
    hdim = emb // nheads
    rows = batch * seq

    g2 = grad.reshape(rows, emb)
    x2 = x.reshape(rows, emb)

    dWo = torch.matmul(saved["merged"].reshape(rows, emb).t(), g2)
    dOut = torch.matmul(g2, wo.t()).reshape(batch, seq, nheads, hdim).transpose(1, 2)

    q, k, v = saved["q"], saved["k"], saved["v"]
    if algo == "flash":
        dq, dk, dv = _flash.backward(q, k, v, saved["out"], saved["lse"], dOut, causal)
    else:
        dq, dk, dv = attentionBackward(q, k, v, dOut, causal)

    # the three projections' backward as one product each way: the heads'
    # gradients side by side, (rows, 3 emb) as [dq | dk | dv], against the
    # weights side by side, so dx sums the three in f32 inside one product
    heads = torch.stack((dq, dk, dv), dim=2).permute(0, 3, 2, 1, 4).reshape(rows, 3 * emb)

    dx = torch.matmul(heads, torch.cat((wq, wk, wv), dim=1).t())
    dW = torch.matmul(x2.t(), heads).split(emb, dim=1)

    grads = (dx.reshape(x.shape), *dW, dWo)

    if bq is not None:
        db = heads.float().sum(dim=0).split(emb)
        grads += tuple(g.to(b.dtype) for g, b in zip(db, (bq, bk, bv))) + (g2.float().sum(dim=0).to(bo.dtype), )

    return grads
