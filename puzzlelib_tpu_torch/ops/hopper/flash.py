"""Kernels K4, the flash-attention forward, and K5a / K5b, its backward, for
Hopper, hand-written in CUDA C++ (``csrc/flash.cu``, ``csrc/flash_bwd.cu``).

K4 replaces ``puzzlelib_tpu/ops/pallas/flash.py`` ``_flashKernel`` (wrapper
``_flashForward``).  ``flash(q, k, v, causal)`` takes q (batch, heads,
seqQ, d) and k, v (batch, heads, seqK, d) and returns ``(out, lse)``: out
(batch, heads, seqQ, d) in the input's type and each query row's logsumexp
in f32 as (batch * heads, 1, seqQ), the TPU kernel's layout, which the
backward kernels read.  The scale is 1 / sqrt(d); a causal mask is aligned
bottom-right (query i sees keys up to i + seqK - seqQ) and sets masked
scores to -1e30, as the TPU kernel does.

K5a and K5b replace ``_dqKernel`` and ``_dkvKernel`` (wrapper
``_flashBackward``).  ``backward(q, k, v, out, lse, do, causal)`` returns
``(dq, dk, dv)`` in the inputs' layout and type: K5a walks the key tiles for
each query tile and writes dq, K5b walks the query tiles for each key tile
and writes dk and dv, both recomputing P = exp(s - lse) from the forward's
lse, with delta = rowsum(dO * out) taken here by one reduction, as the
reference takes it outside Pallas; ``dq`` and ``dkv`` are the two kernels'
own wrappers on operands it has prepared.  ``FlashAttention`` (and
``flashAttention``) is the differentiable attention of the reference's
``flashAttention`` ``custom_vjp``: forward ``flash``, backward ``backward``.

The kernels take bf16 and f16 at head dims 32, 64 and 128; f32 raises
``TypeError``, since Hopper's tensor cores have no f32 mode.  Their designs
are in the notes at the top of the sources.

``plain`` and ``backwardPlain`` are the same functions in plain PyTorch: f32
scores, the same mask constant, f32 softmax statistics, and P (and dS in the
backward) rounded to the input's type for the products that take them, where
the kernels round them for the tensor cores.  ``flash`` and ``backward``
take them for tensors on the CPU, where no kernel can run; for CUDA tensors
they launch the kernels or raise.  ``launches``, ``launchesDq`` and
``launchesDkv`` count kernel launches.
"""

import ctypes
import math

import torch

from puzzlelib_tpu_torch.ops.hopper import build


launches = 0
launchesDq = 0
launchesDkv = 0

NEG_INF = -1e30

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.bfloat16: 1, torch.float16: 2}


def _mask(s, causal):
    """Scores (..., seqQ, seqK) with the bottom-right causal mask at -1e30."""
    if not causal:
        return s

    seqQ, seqK = s.shape[-2:]
    qPos = torch.arange(seqQ, device=s.device)[:, None]
    kPos = torch.arange(seqK, device=s.device)[None, :]
    return s.masked_fill(qPos + (seqK - seqQ) < kPos, NEG_INF)


def plain(q, k, v, causal=False):
    """(out, lse) of attention over (batch, heads, seq, d) in plain PyTorch."""
    batch, heads, seqQ, d = q.shape
    seqK = k.shape[2]

    s = _mask(torch.matmul(q.float() * (1.0 / math.sqrt(d)), k.float().transpose(-1, -2)), causal)

    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)

    out = torch.matmul(p.to(q.dtype).float(), v.float()) / l
    lse = (m + torch.log(l)).reshape(batch * heads, 1, seqQ)

    return out.to(q.dtype), lse


def _entry(name, symbol, pointers):
    lib = build.load(name)
    fn = getattr(lib, symbol)

    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    return fn


def _check(q, k, v):
    if not (q.device == k.device == v.device):
        raise ValueError("flash operands on %s, %s and %s" % (q.device, k.device, v.device))

    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] or \
            q.shape[3] != k.shape[3]:
        raise ValueError("flash takes q (batch, heads, seqQ, d), k and v (batch, heads, seqK, d), got %s, %s, %s" %
                         (tuple(q.shape), tuple(k.shape), tuple(v.shape)))

    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash takes operands of one type, got %s, %s, %s" % (q.dtype, k.dtype, v.dtype))

    if k.shape[2] == 0:
        raise ValueError("flash needs at least one key")


def _cudaOperands(*tensors):
    """The operands as the kernels read them: contiguous (batch * heads, seq,
    d) rows of a type and head dim they take, 16-byte aligned."""
    if tensors[0].dtype not in _DTYPES:
        raise TypeError("the flash kernels take bf16 or f16 (Hopper's tensor cores have no f32 mode), got %s" %
                        tensors[0].dtype)

    d = tensors[0].shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError("the flash kernels take head dims %s, got %d" % (HEAD_DIMS, d))

    tensors = [t.contiguous() for t in tensors]
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the flash kernels take 16-byte aligned operands")

    return tensors


def flash(q, k, v, causal=False):
    """(out, lse) of attention, through kernel K4 on CUDA tensors."""
    _check(q, k, v)

    if q.device.type == "cpu":
        return plain(q, k, v, causal)

    if q.device.type != "cuda":
        raise ValueError("flash runs on CUDA or CPU tensors, got %s" % q.device)

    batch, heads, seqQ, d = q.shape
    seqK = k.shape[2]

    # the kernel reads (batch * heads, seq, d) rows; a transposed head layout
    # is copied once here
    q, k, v = _cudaOperands(q, k, v)

    out = torch.empty_like(q)
    lse = torch.empty((batch * heads, 1, seqQ), dtype=torch.float32, device=q.device)

    if batch * heads == 0 or seqQ == 0:
        return out, lse

    with torch.cuda.device(q.device):
        err = _entry("flash", "pl_flash_forward", 5)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            batch * heads, seqQ, seqK, d, _DTYPES[q.dtype], int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)

    if err != 0:
        raise RuntimeError("flash kernel launch failed for q %s, k %s %s: cudaError %d" %
                           (tuple(q.shape), tuple(k.shape), q.dtype, err))

    global launches
    launches += 1
    return out, lse


def backwardPlain(q, k, v, out, lse, do, causal=False):
    """(dq, dk, dv) of attention in plain PyTorch, from the forward's ``out``
    and ``lse`` (batch * heads, 1, seqQ): the FlashAttention-2 backward of
    the reference's ``_dqKernel`` and ``_dkvKernel``, without the tiles.

    delta = rowsum(dO * out) in f32 from the rounded ``out``; s = (q k^T) *
    scale in f32 with the causal mask at -1e30; P = exp(s - lse), so a row
    that sees no key weighs every key 1, as the TPU kernel's backward does;
    dP = dO v^T and dS = P * (dP - delta) in f32.  P is rounded to the
    input's type for dv = P^T dO and dS for dq = dS k * scale and dk = dS^T
    q * scale, where the kernels round them for the tensor cores."""
    batch, heads, seqQ, d = q.shape
    scale = 1.0 / math.sqrt(d)
    dtype = q.dtype

    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    delta = (do32 * out.float()).sum(dim=-1, keepdim=True)

    s = _mask(torch.matmul(q32, k32.transpose(-1, -2)) * scale, causal)
    p = torch.exp(s - lse.reshape(batch, heads, seqQ, 1))

    ds = p * (torch.matmul(do32, v32.transpose(-1, -2)) - delta)
    p, ds = p.to(dtype).float(), ds.to(dtype).float()

    dq = torch.matmul(ds, k32) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q32) * scale
    dv = torch.matmul(p.transpose(-1, -2), do32)

    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def backward(q, k, v, out, lse, do, causal=False):
    """(dq, dk, dv) of attention, through kernels K5a (dq) and K5b (dk, dv)
    on CUDA tensors.  ``out`` and ``lse`` are ``flash``'s, ``do`` is the
    gradient of ``out``."""
    _check(q, k, v)

    batch, heads, seqQ, d = q.shape
    seqK = k.shape[2]

    if out.shape != q.shape or do.shape != q.shape or out.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError("flash backward takes out and do of q's shape %s and type %s, got %s %s and %s %s" %
                         (tuple(q.shape), q.dtype, tuple(out.shape), out.dtype, tuple(do.shape), do.dtype))

    if tuple(lse.shape) != (batch * heads, 1, seqQ) or lse.dtype != torch.float32:
        raise ValueError("flash backward takes lse (batch * heads, 1, seqQ) in f32, got %s %s" %
                         (tuple(lse.shape), lse.dtype))

    if any(t.device != q.device for t in (out, lse, do)):
        raise ValueError("flash backward operands on several devices")

    if q.device.type == "cpu":
        return backwardPlain(q, k, v, out, lse, do, causal)

    if q.device.type != "cuda":
        raise ValueError("flash backward runs on CUDA or CPU tensors, got %s" % q.device)

    q, k, v, do = _cudaOperands(q, k, v, do)
    lse = lse.contiguous()

    # delta_i = rowsum(dO * out): one reduction, outside the kernels, as the
    # reference takes it outside Pallas
    delta = (do.float() * out.float()).sum(dim=-1).contiguous()

    return dq(q, k, v, do, lse, delta, causal), *dkv(q, k, v, do, lse, delta, causal)


def _launchArgs(q, k, lse, delta, causal):
    batch, heads, seqQ, d = q.shape
    if tuple(delta.shape) != (batch, heads, seqQ) or delta.dtype != torch.float32 or not delta.is_contiguous() or \
            not lse.is_contiguous():
        raise ValueError("the flash backward kernels take contiguous f32 lse and delta of q's rows")

    return (batch * heads, seqQ, k.shape[2], d, _DTYPES[q.dtype], int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)


def dq(q, k, v, do, lse, delta, causal=False):
    """Kernel K5a on CUDA operands as ``backward`` prepares them
    (``_cudaOperands``; delta (batch, heads, seqQ) f32): dq."""
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out

    with torch.cuda.device(q.device):
        err = _entry("flash_bwd", "pl_flash_backward_dq", 7)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            out.data_ptr(), *_launchArgs(q, k, lse, delta, causal))

    if err != 0:
        raise RuntimeError("flash dq kernel launch failed for q %s, k %s %s: cudaError %d" %
                           (tuple(q.shape), tuple(k.shape), q.dtype, err))

    global launchesDq
    launchesDq += 1
    return out


def dkv(q, k, v, do, lse, delta, causal=False):
    """Kernel K5b on CUDA operands as ``backward`` prepares them: (dk, dv)."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0 or q.shape[2] == 0:
        return dk.zero_(), dv.zero_()

    with torch.cuda.device(q.device):
        err = _entry("flash_bwd", "pl_flash_backward_dkv", 8)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), *_launchArgs(q, k, lse, delta, causal))

    if err != 0:
        raise RuntimeError("flash dk/dv kernel launch failed for q %s, k %s %s: cudaError %d" %
                           (tuple(q.shape), tuple(k.shape), q.dtype, err))

    global launchesDkv
    launchesDkv += 1
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention, the counterpart of the reference's
    ``flashAttention`` ``custom_vjp``: the forward is ``flash``, the backward
    ``backward`` over the saved q, k, v, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal=False):
        out, lse = flash(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = backward(q, k, v, out, lse, do.to(q.dtype), ctx.causal)
        return dq, dk, dv, None


def flashAttention(q, k, v, causal=False):
    """q, k, v (batch, heads, seq, d) -> out (batch, heads, seqQ, d), with the
    flash backward under autograd."""
    return FlashAttention.apply(q, k, v, causal)
