"""Elementwise ops (counterpart of ``puzzlelib_tpu/ops/elementwise.py``):
the seven activations (sigmoid, tanh, relu, leakyRelu, elu, softPlus, clip)
and their derivatives taken from the output, gelu and its derivative, dropout, the affine
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


# -- activations: fwd(x, *args) and der(outgrad, outdata, *args), each in the
# tensor's type, its scalars rounded to that type first, as the reference's
# ``jnp.asarray(a, x.dtype)`` rounds them

def sigmoid(x):
    return torch.sigmoid(x)


def sigmoidDer(grad, out):
    return grad * out * (1 - out)


def tanh(x):
    return torch.tanh(x)


def tanhDer(grad, out):
    return grad * (1 - out * out)


def relu(x):
    return torch.relu(x)


def reluDer(grad, out):
    """The input gradient of relu from its output: grad where out > 0."""
    return grad * (out > 0).to(grad.dtype)


def leakyRelu(x, a):
    return torch.where(x > 0, x, x * _scalar(a, x.dtype))


def leakyReluDer(grad, out, a):
    return grad * torch.where(out > 0, 1.0, _scalar(a, out.dtype)).to(grad.dtype)


def elu(x, a):
    return torch.where(x > 0, x, _scalar(a, x.dtype) * torch.expm1(x))


def eluDer(grad, out, a):
    return grad * torch.where(out > 0, torch.ones_like(out), out + _scalar(a, out.dtype))


def softPlus(x):
    return torch.log1p(torch.exp(x))


def softPlusDer(grad, out):
    return grad * (1 - torch.exp(-out))


def clip(x, a, b):
    return torch.clamp(x, _scalar(a, x.dtype), _scalar(b, x.dtype))


def clipDer(grad, out, a, b):
    return grad * ((out > _scalar(a, out.dtype)) & (out < _scalar(b, out.dtype))).to(grad.dtype)


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



# The steps below round every product or sum of two scalars to the tensor's
# type, as the reference's traced scalars of that type are rounded: the same
# values come out whether the scalars are Python numbers (the eager step) or
# 0-d f32 tensors on the device (a fused step), so the two steps agree.

def nesterovMomSGD_(param, grad, mom, learnRate, momRate):
    """One Nesterov momentum step in place, in the parameter's type: param
    += momRate^2 * mom + (1 + momRate) * learnRate * grad with the old
    momentum, then mom = momRate * mom + learnRate * grad."""
    lr, mr = _scalar(learnRate, grad.dtype), _scalar(momRate, mom.dtype)
    mr2 = _scalar(mr * mr, mom.dtype)
    coef = _scalar(_scalar(1 + mr, mom.dtype) * lr, grad.dtype)

    newmom = mr * mom + lr * grad
    param.copy_(param + mr2 * mom + coef * grad)
    mom.copy_(newmom)


def adagrad_(param, grad, h, learnRate, epsilon):
    """One AdaGrad step in place: h += grad^2; param += learnRate * grad /
    (sqrt(h) + epsilon), in the parameter's type."""
    lr, eps = _scalar(learnRate, grad.dtype), _scalar(epsilon, grad.dtype)

    h.add_(grad * grad)
    param.add_(lr * grad / (h.sqrt() + eps))


def adadelta_(param, grad, msg, msdx, rho, epsilon):
    """One AdaDelta step in place: msg += (1 - rho) * (grad^2 - msg); dx =
    sqrt((msdx + epsilon) / (msg + epsilon)) * grad; msdx += (1 - rho) *
    (dx^2 - msdx); param += dx, in the parameter's type.  No learning rate
    enters it."""
    rho, eps = _scalar(rho, grad.dtype), _scalar(epsilon, grad.dtype)
    keep = _scalar(1 - rho, grad.dtype)

    msg.add_(keep * (grad * grad - msg))
    dx = torch.sqrt((msdx + eps) / (msg + eps)) * grad
    msdx.add_(keep * (dx * dx - msdx))
    param.add_(dx)


def rmsprop_(param, grad, ms, learnRate, factor, epsilon):
    """One RMSProp step in place: ms = factor * ms + (1 - factor) * grad^2;
    param += learnRate * grad / (sqrt(ms) + epsilon), in the parameter's
    type."""
    lr, f, eps = (_scalar(value, grad.dtype) for value in (learnRate, factor, epsilon))
    rest = _scalar(1 - f, grad.dtype)

    ms.copy_(f * ms + rest * grad * grad)
    param.add_(lr * grad / (ms.sqrt() + eps))


def rmspropGraves_(param, grad, mg, ms, delta, learnRate, alpha, momRate, epsilon):
    """One step of Graves' RMSProp in place: ms = alpha * ms + (1 - alpha) *
    grad^2; mg = alpha * mg + (1 - alpha) * grad; delta = momRate * delta +
    learnRate * grad / sqrt(ms - mg^2 + epsilon); param += delta, in the
    parameter's type."""
    lr, a, mr, eps = (_scalar(value, grad.dtype) for value in (learnRate, alpha, momRate, epsilon))
    rest = _scalar(1 - a, grad.dtype)

    ms.copy_(a * ms + rest * grad * grad)
    mg.copy_(a * mg + rest * grad)
    delta.copy_(mr * delta + lr * grad / torch.sqrt(ms - mg * mg + eps))
    param.add_(delta)


def smorms3_(param, grad, mem, mg, ms, learnRate, epsilon):
    """One SMORMS3 step in place: r = 1 / (mem + 1); mg = (1 - r) * mg + r *
    grad; ms = (1 - r) * ms + r * grad^2; x = mg^2 / (ms + epsilon); mem = 1
    + mem * (1 - x); param += grad * min(learnRate, x) / (sqrt(ms) +
    epsilon).  mem, mg and ms are f32; the scalars are rounded to the
    gradient's type first, the rest is taken in f32 and the update rounded
    once to the parameter's type."""
    lr, eps = _scalar(learnRate, grad.dtype), _scalar(epsilon, grad.dtype)
    g = grad.float()

    r = 1 / (mem + 1)
    mg.copy_((1 - r) * mg + r * g)
    ms.copy_((1 - r) * ms + r * g * g)
    x = mg * mg / (ms + eps)

    mem.copy_(1 + mem * (1 - x))
    rate = torch.minimum(x, lr.float()) if isinstance(lr, torch.Tensor) else x.clamp(max=lr)
    param.copy_(param.float() + g * rate / (ms.sqrt() + eps))
