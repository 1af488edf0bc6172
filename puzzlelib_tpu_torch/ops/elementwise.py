"""Elementwise ops (counterpart of ``puzzlelib_tpu/ops/elementwise.py``):
relu and its derivative, gelu and its derivative, the affine ``linear``, the
vector updates, the momentum-SGD step and the Adam step.

The reference's ops return new arrays; the update ops here write in place,
so that they reach parameters and gradients that are views of an optimizer's
flat buffers.  Scalars are rounded to the tensor's type first, as the
reference's ``jnp.asarray(rate, dtype)`` rounds them, and every op runs in the
tensor's type (no f32 master copy of bf16 parameters).
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


def linear(x, a, b):
    """a * x + b, with a and b rounded to x's type first, as the reference
    rounds them."""
    return x * _scalar(a, x.dtype) + _scalar(b, x.dtype)


def _scalar(value, dtype):
    """A Python scalar rounded to ``dtype``."""
    return torch.tensor(value, dtype=dtype).item()


def toVectorAddVector_(y, x, alpha):
    """y += alpha * x, in place."""
    return y.add_(x * _scalar(alpha, x.dtype))


def add_(out, a, alpha, b, beta):
    """out = alpha * a + beta * b, written into ``out`` (which may be b)."""
    return out.copy_(a * _scalar(alpha, a.dtype) + b * _scalar(beta, b.dtype))


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
