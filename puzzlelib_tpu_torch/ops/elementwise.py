"""Elementwise ops (counterpart of ``puzzlelib_tpu/ops/elementwise.py``):
relu and its derivative, gelu and its derivative, dropout, the affine
``linear``, the vector updates, the optimizer hooks' weight decay and
gradient clipping, the momentum-SGD step and the Adam step.

The reference's ops return new arrays; the update ops here write in place,
so that they reach parameters and gradients that are views of an optimizer's
flat buffers.  Scalars are rounded to the tensor's type first, as the
reference's ``jnp.asarray(rate, dtype)`` rounds them, and every op runs in the
tensor's type (no f32 master copy of bf16 parameters).  A scalar is a Python
number, or, inside a fused step, a 0-d tensor on the device.
"""

import torch


def relu(x):
    return torch.relu(x)


def relu_(x):
    """relu in place, for ``Activation(inplace=True)``."""
    return torch.relu_(x)


def reluDer(grad, out):
    """The input gradient of relu from its output: grad where out > 0."""
    return grad * (out > 0).to(grad.dtype)


def gelu(x):
    """The tanh approximation with the reference's constants, computed in f32
    and rounded once to x's type."""
    f, c = 0.7978845608028654, 0.044715   # sqrt(2 / pi)
    x32 = x.float()
    return (0.5 * x32 * (1.0 + torch.tanh(f * (x32 + c * x32 * x32 * x32)))).to(x.dtype)


def geluDer(grad, x):
    """The input gradient of ``gelu`` from its *input* x, as the reference
    derives it, with its constants: computed in f32 and rounded once to the
    gradient's type."""
    f, c = 0.7978845608028654, 0.044715   # sqrt(2 / pi)
    x32 = x.float()
    t = torch.tanh(f * (x32 + c * x32 * x32 * x32))
    dt = (1.0 - t * t) * f * (1.0 + 3 * c * x32 * x32)
    return (grad.float() * (0.5 * (1.0 + t) + 0.5 * x32 * dt)).to(grad.dtype)


def dropout(x, b, v, p, slice=None):
    """x where its draw b lies below v, else 0, divided by the keep share p
    rounded to x's type, as the reference divides.  ``slice`` (of x's flat
    view) drops out only the cells it selects and passes the rest through,
    as the reference's kernel does."""
    if slice is not None:
        out = x.clone()
        out.view(-1)[slice] = dropout(x.reshape(-1)[slice], b.reshape(-1)[slice], v, p)
        return out

    keep = (b < v).to(x.dtype)
    return x * keep / torch.full((), p, dtype=x.dtype, device=x.device)


def dropout2d(x, b, v, p):
    """``dropout`` with one draw per (image, map): b (batch, maps) spans x's
    spatial dims."""
    return dropout(x, b.reshape(tuple(b.shape) + (1, ) * (x.dim() - b.dim())), v, p)


def linear(x, a, b):
    """a * x + b, with a and b rounded to x's type first, as the reference
    rounds them."""
    return x * _scalar(a, x.dtype) + _scalar(b, x.dtype)


def _scalar(value, dtype):
    """A Python scalar rounded to ``dtype``, or, for a 0-d tensor (a fused
    step's hyper-parameter, ``fusedctx``), that tensor rounded to ``dtype``
    on its device, with no readback."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype)

    return torch.tensor(value, dtype=dtype).item()


def toVectorAddVector_(y, x, alpha):
    """y += alpha * x, in place."""
    return y.add_(x * _scalar(alpha, x.dtype))


def add_(out, a, alpha, b, beta):
    """out = alpha * a + beta * b, written into ``out`` (which may be b)."""
    return out.copy_(a * _scalar(alpha, a.dtype) + b * _scalar(beta, b.dtype))


def weightDecay_(grad, param, rate):
    """grad -= rate * param, in place (the gradient is the descent
    direction, so the decay is subtracted)."""
    return grad.sub_(param * _scalar(rate, grad.dtype))


def gradClipNorm_(grad, maxnorm):
    """grad *= min(1, maxnorm / |grad|), in place; the L2 norm and the
    scale are taken in f32, the scale rounded to the gradient's type."""
    norm = grad.float().square().sum().sqrt()
    scale = torch.clamp(maxnorm / torch.clamp(norm, min=1e-12), max=1.0)
    return grad.mul_(scale.to(grad.dtype))


def classicMomSGD_(param, grad, mom, learnRate, momRate):
    """mom = momRate * mom + learnRate * grad; param += mom: both in place,
    in the parameter's type.  The update is added: costs give the descent
    direction."""
    mom.mul_(_scalar(momRate, mom.dtype)).add_(grad * _scalar(learnRate, grad.dtype))
    param.add_(mom)


def adam_(param, grad, mg, ms, learnRate, fix1, fix2, epsilon):
    """One Adam step in place, statement by statement as the reference's:
    mg += fix1 * (grad - mg); ms += fix2 * (grad * grad - ms); param +=
    learnRate * mg / (sqrt(ms) + epsilon).  mg and ms are f32; the four
    scalars are rounded to the gradient's type first, as the reference's
    ``jnp.asarray(..., grad.dtype)`` rounds them (in bf16, 1 - 0.999 is
    0.00099945 and 1 - 0.9 is 0.10009766); grad * grad is taken in f32, as
    XLA takes the reference's bf16 product; the update is summed in f32 and
    rounded once to the parameter's type, which stays as it is."""
    lr, f1, f2, eps = (_scalar(value, grad.dtype) for value in (learnRate, fix1, fix2, epsilon))
    g = grad.float()

    mg.add_(f1 * (g - mg))
    ms.add_(f2 * (g * g - ms))
    param.copy_(param.float() + lr * mg / (ms.sqrt() + eps))
