"""Probe P3: the streaming ``x + 1``, hand-written in CUDA C++
(``csrc/streamcopy.cu``).

Replaces ``tools/roofline_probe.py`` ``copyKernel`` (through ``pallasCopy``),
the Pallas kernel that streams bf16 values through VMEM to measure the TPU's
read + write bandwidth.  ``addOne(x)`` returns ``x + 1`` over a tensor of
bf16, f16 or f32, computed in f32 and rounded once to x's type, which is the
correctly rounded sum: the kernel and ``plain`` agree bit for bit.  What
bounds it (the bytes) and how it streams is in the note at the top of the
source.

``plain`` is the same function in plain PyTorch.  ``addOne`` takes it for
tensors on the CPU, where no kernel can run; for CUDA tensors it launches the
kernel or raises.  ``launches`` counts kernel launches.
"""

import ctypes

import torch

from puzzlelib_tpu_torch.ops.hopper import build


launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def plain(x):
    return x + torch.ones((), dtype=x.dtype, device=x.device)


def _entry():
    fn = build.load("streamcopy").pl_streamcopy_add_one
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def addOne(x):
    """x + 1 in x's type (bf16, f16 or f32), through probe kernel P3."""
    if x.dtype not in _DTYPES:
        raise TypeError("the streaming kernel takes bf16, f16 or f32, got %s" % x.dtype)

    if x.device.type == "cpu":
        return plain(x)

    if x.device.type != "cuda":
        raise ValueError("the streaming kernel runs on CUDA or CPU tensors, got %s" % x.device)

    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("the streaming kernel takes a 16-byte aligned tensor")

    y = torch.empty_like(x)
    if x.numel() == 0:
        return y

    with torch.cuda.device(x.device):
        err = _entry()(x.data_ptr(), y.data_ptr(), x.numel(), _DTYPES[x.dtype],
                       torch.cuda.current_stream(x.device).cuda_stream)

    if err != 0:
        raise RuntimeError("streaming kernel launch failed for %s %s: cudaError %d" % (tuple(x.shape), x.dtype, err))

    global launches
    launches += 1
    return y
