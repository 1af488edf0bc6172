"""Connectionist Temporal Classification loss (counterpart of
``puzzlelib_tpu/ops/ctc.py``).

Contract, the JAX package's (``hostCTCLoss``'s):

  * data (T, B, V): raw scores, softmaxed in f32 unless ``normalized`` (then
    probabilities, taken as they are in f32);
  * labels: the per-sample label sequences concatenated; lengths (B, ) and
    datalen (B, ), each sample's label count and time length;
  * returns (error, grad): the error is the sum of the per-sample negative
    log-likelihoods (a 0-d f32 tensor), the gradient the descent direction
    -(p - posterior) with respect to the scores, in f32 whatever the
    scores' type, and zero for t >= datalen[b].

The two recursions are the JAX package's log-space ``lax.scan``s written as
loops over time, each step vectorised over the batch and the extended label
slots (``_ctcCore``), with its clamp of unreachable states at -1e30: a
sample whose labels cannot fit in its ``datalen`` gives an error of 1e30,
where ``torch.nn.functional.ctc_loss`` gives inf.  The log-probabilities are
taken in f32, as in the JAX package, and the recursions and the posteriors in
f64: the f32 recursions of the JAX package lose some 3e-3 of the gradient at
the 800 steps of Wave2Letter against ``hostCTCLoss`` in f64.  The per-symbol
sum of the posteriors is a product with the one-hot table of the extended
labels (``torch.bmm``), no scatter with atomics, so the gradient repeats bit
for bit on the card.  Building the extended labels reads ``labels`` and
``lengths`` on the host, as the JAX package does.

``hostCTCLoss`` is the JAX package's independent per-sample f64 numpy
oracle, copied as it is.
"""

import numpy as np
import torch


_NEG = -1e30


def _ctcCore(p, ext, svalid, datalen, blank):
    """p (T, B, V) f32 probabilities; ext (B, S) int64 extended labels;
    svalid (B, ) = 2 * length + 1; datalen (B, ) -> (error, grad)."""
    T, B, V = p.shape
    S = ext.shape[1]
    dev, f64 = p.device, torch.float64
    neg = torch.tensor(_NEG, dtype=f64, device=dev)

    logp = torch.log(torch.clamp(p, min=1e-38))
    lpExt = torch.gather(logp, 2, ext.unsqueeze(0).expand(T, B, S)).to(f64)        # (T, B, S)

    sIdx = torch.arange(S, device=dev).unsqueeze(0)
    sMask = sIdx < svalid[:, None]                                                 # (B, S) valid slots
    lastSlots = (sIdx == svalid[:, None] - 1) | (sIdx == svalid[:, None] - 2)

    none = ext.new_full((B, 2), -1)
    allow2 = (sIdx > 1) & (ext != blank) & (ext != torch.cat([none, ext], dim=1)[:, :S])
    allowFwd2 = (sIdx < svalid[:, None] - 2) & (ext != blank) & (ext != torch.cat([ext, none], dim=1)[:, 2:])

    # -- alpha, two -1e30 columns on the left: the shifted rows are views --------

    alphas = torch.full((T, B, S + 2), _NEG, dtype=f64, device=dev)
    alpha0 = torch.where((sIdx == 0) | ((sIdx == 1) & (svalid[:, None] > 1)), lpExt[0], neg)
    alphas[0, :, 2:] = torch.where(sMask, alpha0, neg)

    for t in range(1, T):
        prev = alphas[t - 1]
        reach = torch.logaddexp(prev[:, 2:], prev[:, 1:S + 1])
        reach = torch.where(allow2, torch.logaddexp(reach, prev[:, :S]), reach)
        torch.where(sMask, reach + lpExt[t], neg, out=alphas[t, :, 2:])

    alphas = alphas[:, :, 2:]

    lastT = torch.clamp(datalen - 1, 0, T - 1).long()
    alphaLast = alphas[lastT, torch.arange(B, device=dev)]                          # (B, S)

    aEnd1 = alphaLast.gather(1, torch.clamp(svalid - 1, 0, S - 1).long()[:, None])[:, 0]
    aEnd2 = alphaLast.gather(1, torch.clamp(svalid - 2, 0, S - 1).long()[:, None])[:, 0]
    nll = -torch.logaddexp(aEnd1, aEnd2)                                           # (B, )

    # -- beta, two -1e30 columns on the right; a sample starts at datalen - 1 ------

    tIdx = torch.arange(T, device=dev)
    isLast = (tIdx[:, None] == datalen[None, :] - 1)[:, :, None]                     # (T, B, 1)
    kill = (tIdx[:, None] > datalen[None, :] - 1)[:, :, None] | ~sMask[None]       # (T, B, S)
    init = torch.where(lastSlots & sMask, lpExt, neg)                               # (T, B, S)

    betas = torch.full((T + 1, B, S + 2), _NEG, dtype=f64, device=dev)
    for t in range(T - 1, -1, -1):
        nxt = betas[t + 1]
        reach = torch.logaddexp(nxt[:, :S], nxt[:, 1:S + 1])
        reach = torch.where(allowFwd2, torch.logaddexp(reach, nxt[:, 2:]), reach)
        recur = torch.where(kill[t], neg, reach + lpExt[t])
        torch.where(isLast[t], init[t], recur, out=betas[t, :, :S])

    betas = betas[:T, :, :S]

    # -- gradient ----------------------------------------------------------------------

    gamma = torch.exp(torch.clamp(alphas + betas + nll[None, :, None], _NEG, 30.0))
    gamma = torch.where(sMask[None], gamma, torch.zeros((), dtype=f64, device=dev))

    onehot = torch.zeros((B, S, V), dtype=f64, device=dev).scatter_(2, ext.unsqueeze(2), 1.0)
    gsum = torch.bmm(gamma.transpose(0, 1), onehot).transpose(0, 1)                 # (T, B, V)

    grad = p.to(f64) - gsum / torch.clamp(p, min=1e-38).to(f64)
    grad = torch.where((tIdx[:, None] < datalen[None, :])[:, :, None], grad, torch.zeros((), dtype=f64, device=dev))

    return nll.sum().float(), (-grad).float()


def _host(ary):
    return ary.detach().cpu().numpy() if isinstance(ary, torch.Tensor) else np.asarray(ary)


def ctcLoss(data, datalen, labels, lengths, blank, normalized=False):
    """(error, grad) of the scores ``data`` (T, B, V), the contract above;
    ``labels`` and ``lengths`` go to the host to build the extended labels."""
    T, B, V = data.shape
    p = data.float() if normalized else torch.softmax(data.float(), dim=2)

    lengthsHost, labelsHost = _host(lengths).astype(np.int64), _host(labels).astype(np.int64)

    maxL = int(lengthsHost.max()) if lengthsHost.size else 1
    S = 2 * maxL + 1

    ext = np.full((B, S), blank, dtype=np.int64)
    offset = 0
    for b in range(B):
        L = int(lengthsHost[b])
        ext[b, 1:2 * L + 1:2] = labelsHost[offset:offset + L]
        offset += L

    device = data.device
    svalid = torch.from_numpy(2 * lengthsHost + 1).to(device)
    datalen = torch.as_tensor(datalen).to(device=device, dtype=torch.int64)

    return _ctcCore(p, torch.from_numpy(ext).to(device), svalid, datalen, int(blank))


def hostCTCLoss(data, datalen, labels, lengths, blank):
    """Independent pure-numpy CTC oracle (per-sample log-space
    forward/backward in float64) that shares no code with ``ctcLoss``.

    Returns (sum of per-sample NLL, dNLL/dlogits with zeros past datalen,
    None) - the reference's ``hostCTCLoss`` output contract."""
    x = _host(data).astype(np.float64)
    datalen, labels, lengths = _host(datalen), _host(labels), _host(lengths)

    ex = np.exp(x - x.max(axis=2, keepdims=True))
    p = ex / ex.sum(axis=2, keepdims=True)                     # (T, B, V)

    T, B, V = p.shape
    NEG = -np.inf

    grad = np.zeros((T, B, V), np.float32)
    nllTotal = 0.0
    offset = 0

    for b in range(B):
        L, Tb = int(lengths[b]), int(datalen[b])

        ext = np.full(2 * L + 1, blank, np.int64)
        ext[1::2] = labels[offset:offset + L]
        offset += L

        S = ext.size
        lp = np.log(np.maximum(p[:Tb, b], 1e-300))[:, ext]     # (Tb, S)

        # skip-transition masks: a non-blank may skip the preceding blank
        # unless it repeats the previous label
        skipIn = np.zeros(S, bool)
        skipIn[2:] = (ext[2:] != blank) & (ext[2:] != ext[:-2])

        skipOut = np.zeros(S, bool)
        skipOut[:-2] = skipIn[2:]

        alpha = np.full((Tb, S), NEG)
        alpha[0, :min(2, S)] = lp[0, :min(2, S)]

        for t in range(1, Tb):
            prev = alpha[t - 1]
            reach = np.logaddexp(prev, np.concatenate(([NEG], prev[:-1])))
            skip = np.concatenate(([NEG, NEG], prev[:-2]))
            alpha[t] = np.where(skipIn, np.logaddexp(reach, skip), reach) + lp[t]

        loglike = alpha[Tb - 1, S - 1] if S < 2 else np.logaddexp(alpha[Tb - 1, S - 1], alpha[Tb - 1, S - 2])
        nll = -loglike
        nllTotal += nll

        beta = np.full((Tb, S), NEG)
        beta[Tb - 1, max(0, S - 2):] = lp[Tb - 1, max(0, S - 2):]

        for t in range(Tb - 2, -1, -1):
            nxt = beta[t + 1]
            reach = np.logaddexp(nxt, np.concatenate((nxt[1:], [NEG])))
            skip = np.concatenate((nxt[2:], [NEG, NEG]))
            beta[t] = np.where(skipOut, np.logaddexp(reach, skip), reach) + lp[t]

        with np.errstate(over="ignore"):
            gamma = np.exp(alpha + beta + nll)                 # (Tb, S)

        occupancy = np.zeros((Tb, V))
        for s in range(S):
            occupancy[:, ext[s]] += gamma[:, s]

        grad[:Tb, b] = (p[:Tb, b] - occupancy / np.maximum(p[:Tb, b], 1e-300)).astype(np.float32)

    return np.float32(nllTotal), grad, None
