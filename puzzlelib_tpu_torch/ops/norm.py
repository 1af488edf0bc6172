"""Batch norm and instance norm (counterpart of the batch-norm and
instance-norm part of ``puzzlelib_tpu/ops/norm.py``).

These are XLA work in the JAX package, with no Pallas kernel, so here they
are torch ops, computed in f32 as the reference computes them:

- batch norm: "spatial" mode reduces over (N, spatial), "perActivation"
  over N only.  var = E[x^2] - mean^2; training saves (mean, invstd) for the
  backward, rounded to x's type, as the reference hands them on (so in a
  bf16 net ``batchNormBackward`` reads them rounded).  In "perActivation"
  mode the stats have one value per activation (the JAX package's
  ``batchNormTrain`` broadcasts them against the flat running stats there
  and fails; ROADMAP Queue 3).  The running stats
  blend as running = (1 - factor) * running + factor * batchstat, with the
  *unbiased* variance, in f32, and are written in place: ``factor`` may be
  a Python number or a 0-d f32 tensor on the device (inside a fused step),
  and a CUDA graph replays the writes to the same addresses with the
  factor's value at each replay.
  Inside a mesh step (``fusedctx.dataGroup()``) the statistics are the
  global batch's, as the JAX mesh step's ``jnp.mean`` over the sharded batch
  gives them: the forward sums its per-map sums of x and x^2 over the data
  group before it forms the mean and variance (the count is the shard's
  times the group's size: the step hands every rank an equal shard), and
  the backward sums its two per-map sums so for dx, while dscale and dbias
  stay the shard's, for the step's gradient mean to average.
- instance norm: batch norm of the (1, N * C, H, W) view with the scale and
  bias tiled N times, as the reference builds it.
- local response norms: y = x / d^beta with d = K + alpha / n * S(x^2),
  where S sums a window of N cells around each cell, across the maps
  (``crossMapLRN``, n = N) or over the spatial axes (``mapLRN``, n =
  N^(dims)); ``divNorm`` normalizes u = x - means so.  A window reaches
  N // 2 cells back and N - 1 - N // 2 forward, zeros outside, as the
  reference pads it (asymmetric for an even N).  The sums run in f32 as
  N shifted adds an axis.  The backward is written in closed form, where
  the reference takes the VJP:
  dx_j = g_j d_j^-beta - (2 alpha beta / n) x_j S'(g x d^(-beta-1))_j,
  with S' the sum over the mirrored window (the cells whose windows hold
  j).  It is elementwise work and shifted adds, so it gives the same bits
  at each call on the card, where ``local_response_norm``'s backward runs
  ``avg_pool3d``'s, which adds with atomics.
"""

import torch
import torch.distributed as dist
import torch.nn.functional as F

from puzzlelib_tpu_torch import fusedctx
from puzzlelib_tpu_torch.backend import collective


MODE_SPATIAL = "spatial"


def _axes(ndim, mode):
    if mode == MODE_SPATIAL:
        return (0, ) + tuple(range(2, ndim))

    return (0, )


def _statShape(x, axes):
    return tuple(1 if i in axes else x.shape[i] for i in range(x.dim()))


def _count(x, axes):
    n = 1
    for a in axes:
        n *= x.shape[a]

    return n


def _normalize(x, scale, bias, epsilon, axes, group=None):
    """(out in f32, batch mean, batch biased variance, invstd, the count),
    the stats per map in f32; with a ``group``, over the group's batch."""
    shape = _statShape(x, axes)

    xf = x.float()
    if group is None:
        n = _count(x, axes)
        mean = xf.mean(dim=axes)
        var = (xf * xf).mean(dim=axes) - mean * mean
    else:
        n = _count(x, axes) * dist.get_world_size(group)
        sums = collective.sumInPlace(torch.stack([xf.sum(dim=axes), (xf * xf).sum(dim=axes)]), group)
        mean = sums[0] / n
        var = sums[1] / n - mean * mean

    invstd = torch.rsqrt(var + epsilon)

    xhat = (xf - mean.reshape(shape)) * invstd.reshape(shape)
    out = xhat * scale.float().reshape(shape) + bias.float().reshape(shape)
    return out, mean, var, invstd, n


def batchNormTrain(x, scale, bias, runMean, runVar, epsilon, factor, mode=MODE_SPATIAL):
    """(out in x's type, saved mean, saved invstd), the saved stats per map
    in x's type; ``runMean`` and ``runVar`` blended with ``factor`` in
    place."""
    axes = _axes(x.dim(), mode)

    out, mean, var, invstd, n = _normalize(x, scale, bias, epsilon, axes, fusedctx.dataGroup())
    unbiased = var * (n / max(n - 1, 1))

    keep = 1 - factor
    runMean.copy_((keep * runMean.float().reshape(-1) + factor * mean.reshape(-1)).reshape(runMean.shape))
    runVar.copy_((keep * runVar.float().reshape(-1) + factor * unbiased.reshape(-1)).reshape(runVar.shape))

    return out.to(x.dtype), mean.to(x.dtype), invstd.to(x.dtype)


def batchNormTest(x, scale, bias, runMean, runVar, epsilon, mode=MODE_SPATIAL):
    """x normalized by the running stats, in x's type."""
    shape = _statShape(x, _axes(x.dim(), mode))

    xf = x.float()
    invstd = torch.rsqrt(runVar.float().reshape(shape) + epsilon)

    out = (xf - runMean.float().reshape(shape)) * invstd * scale.float().reshape(shape) + bias.float().reshape(shape)
    return out.to(x.dtype)


def batchNormBackward(grad, x, scale, savemean, saveinvvar, epsilon, mode=MODE_SPATIAL):
    """(dx in x's type, dscale, dbias in scale's type, shaped as the saved
    stats) from the saved stats as the forward rounded them."""
    return _batchNormBackward(grad, x, scale, savemean, saveinvvar, epsilon, mode, fusedctx.dataGroup())


def _batchNormBackward(grad, x, scale, savemean, saveinvvar, epsilon, mode, group):
    axes = _axes(x.dim(), mode)
    n = _count(x, axes)
    shape = _statShape(x, axes)

    gf, xf = grad.float(), x.float()
    mean = savemean.float().reshape(shape)
    invstd = saveinvvar.float().reshape(shape)

    xhat = (xf - mean) * invstd

    dbias = gf.sum(dim=axes)
    dscale = (gf * xhat).sum(dim=axes)

    sumBias, sumScale = dbias, dscale
    if group is not None:
        n *= dist.get_world_size(group)
        sumBias, sumScale = collective.sumInPlace(torch.stack([dbias, dscale]), group)

    sf = scale.float().reshape(shape)
    dx = sf * invstd / n * (n * gf - sumBias.reshape(shape) - xhat * sumScale.reshape(shape))

    return (
        dx.to(x.dtype),
        dscale.reshape(savemean.shape).to(scale.dtype),
        dbias.reshape(savemean.shape).to(scale.dtype),
    )


# -- instance norm ----------------------------------------------------------------

def _perInstance(x):
    n, c = x.shape[:2]
    return x.reshape((1, n * c) + tuple(x.shape[2:]))


def instanceNorm2d(x, scale, bias, epsilon):
    """(out in x's type, mean and invstd per (n, c) in x's type, the scale
    tiled N times)."""
    n = x.shape[0]
    extscale, extbias = scale.reshape(-1).repeat(n), bias.reshape(-1).repeat(n)

    xr = _perInstance(x)
    out, mean, _, invstd, _ = _normalize(xr, extscale, extbias, epsilon, _axes(xr.dim(), MODE_SPATIAL))
    return out.to(x.dtype).reshape(x.shape), mean.to(x.dtype), invstd.to(x.dtype), extscale


def instanceNorm2dBackward(grad, x, extscale, savemean, saveinvvar, epsilon, affine=True):
    """dx, and with ``affine`` (dx, dscale, dbias), dscale and dbias (C, )
    summed over the batch."""
    n, c = x.shape[:2]

    dx, dscale, dbias = _batchNormBackward(_perInstance(grad), _perInstance(x), extscale, savemean, saveinvvar,
                                           epsilon, MODE_SPATIAL, None)
    dx = dx.reshape(x.shape)

    if not affine:
        return dx

    return dx, dscale.reshape(n, c).sum(dim=0), dbias.reshape(n, c).sum(dim=0)


# -- local response norms -----------------------------------------------------

def _windowSum(t, N, dims, mirrored=False):
    """Each cell of t summed with its window's cells along each axis of
    ``dims``: N // 2 cells back and N - 1 - N // 2 forward (``mirrored``:
    the other way round), zeros outside; N shifted adds an axis, in t's
    type."""
    back = N // 2
    back, forward = (N - 1 - back, back) if mirrored else (back, N - 1 - back)

    for dim in dims:
        n = t.shape[dim]
        padded = F.pad(t, [0, 0] * (t.dim() - dim - 1) + [back, forward])

        acc = padded.narrow(dim, 0, n)
        for shift in range(1, N):
            acc = acc + padded.narrow(dim, shift, n)
        t = acc

    return t


def _lrnDims(x, crossMap):
    return (1, ) if crossMap else tuple(range(2, x.dim()))


def _lrnForward(u, N, alpha, beta, K, crossMap):
    """(u / d^beta in f32, d in f32) of the f32 tensor u."""
    dims = _lrnDims(u, crossMap)
    denom = K + alpha / N ** len(dims) * _windowSum(u * u, N, dims)
    return u / denom ** beta, denom


def _lrnBackward(u, grad, denom, N, alpha, beta, crossMap):
    """The gradient in u (f32) of ``_lrnForward``'s output, from the saved d."""
    dims = _lrnDims(u, crossMap)
    g = grad.float()

    scaled = denom ** -beta
    spread = _windowSum(g * u * scaled / denom, N, dims, mirrored=True)
    return g * scaled - (2.0 * alpha * beta / N ** len(dims)) * u * spread


def crossMapLRN(x, N, alpha, beta, K):
    """(y in x's type, d in f32): the LRN across the maps of x (N, C, ...)."""
    out, denom = _lrnForward(x.float(), N, alpha, beta, K, crossMap=True)
    return out.to(x.dtype), denom


def crossMapLRNBackward(x, grad, denom, N, alpha, beta):
    return _lrnBackward(x.float(), grad, denom, N, alpha, beta, crossMap=True).to(grad.dtype)


def mapLRN(x, N, alpha, beta, K):
    """(y in x's type, d in f32): the LRN over an N x N (x N) window of each
    map of x."""
    out, denom = _lrnForward(x.float(), N, alpha, beta, K, crossMap=False)
    return out.to(x.dtype), denom


def mapLRNBackward(x, grad, denom, N, alpha, beta):
    return _lrnBackward(x.float(), grad, denom, N, alpha, beta, crossMap=False).to(grad.dtype)


def divNorm(x, means, N, alpha, beta, K):
    """(y in x's type, d in f32): ``mapLRN`` of u = x - means (local
    contrast normalization's divisive step, cuDNN's DivisiveNormalization
    with precomputed means)."""
    out, denom = _lrnForward(x.float() - means.float(), N, alpha, beta, K, crossMap=False)
    return out.to(x.dtype), denom


def divNormBackward(x, means, grad, denom, N, alpha, beta):
    """(dx, dmeans) of ``divNorm``: the gradient in u and its negative."""
    du = _lrnBackward(x.float() - means.float(), grad, denom, N, alpha, beta, crossMap=False)
    return du.to(grad.dtype), (-du).to(grad.dtype)
