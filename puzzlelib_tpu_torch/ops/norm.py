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
- instance norm: batch norm of the (1, N * C, H, W) view with the scale and
  bias tiled N times, as the reference builds it.

LRN and ``divNorm`` are not ported yet.
"""

import torch


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


def _normalize(x, scale, bias, epsilon, axes):
    """(out in f32, batch mean, batch biased variance, invstd), the stats
    per map in f32."""
    shape = _statShape(x, axes)

    xf = x.float()
    mean = xf.mean(dim=axes)
    var = (xf * xf).mean(dim=axes) - mean * mean
    invstd = torch.rsqrt(var + epsilon)

    xhat = (xf - mean.reshape(shape)) * invstd.reshape(shape)
    out = xhat * scale.float().reshape(shape) + bias.float().reshape(shape)
    return out, mean, var, invstd


def batchNormTrain(x, scale, bias, runMean, runVar, epsilon, factor, mode=MODE_SPATIAL):
    """(out in x's type, saved mean, saved invstd), the saved stats per map
    in x's type; ``runMean`` and ``runVar`` blended with ``factor`` in
    place."""
    axes = _axes(x.dim(), mode)
    n = _count(x, axes)

    out, mean, var, invstd = _normalize(x, scale, bias, epsilon, axes)
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
    axes = _axes(x.dim(), mode)
    n = _count(x, axes)
    shape = _statShape(x, axes)

    gf, xf = grad.float(), x.float()
    mean = savemean.float().reshape(shape)
    invstd = saveinvvar.float().reshape(shape)

    xhat = (xf - mean) * invstd

    dbias = gf.sum(dim=axes)
    dscale = (gf * xhat).sum(dim=axes)

    sf = scale.float().reshape(shape)
    dx = sf * invstd / n * (n * gf - dbias.reshape(shape) - xhat * dscale.reshape(shape))

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
    out, mean, _, invstd = _normalize(xr, extscale, extbias, epsilon, _axes(xr.dim(), MODE_SPATIAL))
    return out.to(x.dtype).reshape(x.shape), mean.to(x.dtype), invstd.to(x.dtype), extscale


def instanceNorm2dBackward(grad, x, extscale, savemean, saveinvvar, epsilon, affine=True):
    """dx, and with ``affine`` (dx, dscale, dbias), dscale and dbias (C, )
    summed over the batch."""
    n, c = x.shape[:2]

    dx, dscale, dbias = batchNormBackward(_perInstance(grad), _perInstance(x), extscale, savemean, saveinvvar,
                                          epsilon, mode=MODE_SPATIAL)
    dx = dx.reshape(x.shape)

    if not affine:
        return dx

    return dx, dscale.reshape(n, c).sum(dim=0), dbias.reshape(n, c).sum(dim=0)
