"""Kernel K4: the flash-attention forward for Hopper, hand-written in CUDA C++
(``csrc/flash.cu``).

Replaces ``puzzlelib_tpu/ops/pallas/flash.py`` ``_flashKernel`` (wrapper
``_flashForward``).  ``flash(q, k, v, causal)`` takes q (batch, heads,
seqQ, d) and k, v (batch, heads, seqK, d) and returns ``(out, lse)``: out
(batch, heads, seqQ, d) in the input's type and each query row's logsumexp
in f32 as (batch * heads, 1, seqQ), the TPU kernel's layout, which the
backward kernels will read.  The scale is 1 / sqrt(d); a causal mask is
aligned bottom-right (query i sees keys up to i + seqK - seqQ) and sets
masked scores to -1e30, as the TPU kernel does.  The kernel takes bf16 and
f16 at head dims 32, 64 and 128; f32 raises ``TypeError``, since Hopper's
tensor cores have no f32 mode.  Its design is in the note at the top of
``csrc/flash.cu``.

``plain`` is the same function in plain PyTorch: f32 scores, the same mask
constant, f32 softmax statistics, and the probabilities rounded to the
input's type for the product with v, where the kernel and the TPU kernel
round them.  ``flash`` takes it for tensors on the CPU, where no kernel can
run; for CUDA tensors it launches the kernel or raises.  ``launches`` counts
kernel launches.
"""

import ctypes
import math

import torch

from puzzlelib_tpu_torch.ops.hopper import build


launches = 0

NEG_INF = -1e30

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.bfloat16: 1, torch.float16: 2}


def plain(q, k, v, causal=False):
    """(out, lse) of attention over (batch, heads, seq, d) in plain PyTorch."""
    batch, heads, seqQ, d = q.shape
    seqK = k.shape[2]

    s = torch.matmul(q.float() * (1.0 / math.sqrt(d)), k.float().transpose(-1, -2))

    if causal:
        qPos = torch.arange(seqQ, device=q.device)[:, None]
        kPos = torch.arange(seqK, device=q.device)[None, :]
        s = s.masked_fill(qPos + (seqK - seqQ) < kPos, NEG_INF)

    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)

    out = torch.matmul(p.to(q.dtype).float(), v.float()) / l
    lse = (m + torch.log(l)).reshape(batch * heads, 1, seqQ)

    return out.to(q.dtype), lse


def _entry():
    lib = build.load("flash")

    lib.pl_flash_forward.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.pl_flash_forward.restype = ctypes.c_int

    return lib.pl_flash_forward


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


def flash(q, k, v, causal=False):
    """(out, lse) of attention, through kernel K4 on CUDA tensors."""
    _check(q, k, v)

    if q.device.type == "cpu":
        return plain(q, k, v, causal)

    if q.device.type != "cuda":
        raise ValueError("flash runs on CUDA or CPU tensors, got %s" % q.device)

    if q.dtype not in _DTYPES:
        raise TypeError("the flash kernel takes bf16 or f16 (Hopper's tensor cores have no f32 mode), got %s" %
                        q.dtype)

    batch, heads, seqQ, d = q.shape
    seqK = k.shape[2]

    if d not in HEAD_DIMS:
        raise ValueError("the flash kernel takes head dims %s, got %d" % (HEAD_DIMS, d))

    # the kernel reads (batch * heads, seq, d) rows; a transposed head layout
    # is copied once here
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the flash kernel takes 16-byte aligned operands")

    out = torch.empty_like(q)
    lse = torch.empty((batch * heads, 1, seqQ), dtype=torch.float32, device=q.device)

    if batch * heads == 0 or seqQ == 0:
        return out, lse

    with torch.cuda.device(q.device):
        err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                       batch * heads, seqQ, seqK, d, _DTYPES[q.dtype], int(bool(causal)),
                       torch.cuda.current_stream(q.device).cuda_stream)

    if err != 0:
        raise RuntimeError("flash kernel launch failed for q %s, k %s %s: cudaError %d" %
                           (tuple(q.shape), tuple(k.shape), q.dtype, err))

    global launches
    launches += 1
    return out, lse
