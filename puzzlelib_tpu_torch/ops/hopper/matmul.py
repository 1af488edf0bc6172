"""Kernel K1: tiled GEMM for Hopper, hand-written in CUDA C++ (``csrc/matmul.cu``).

Replaces ``puzzlelib_tpu/ops/pallas/matmul.py`` ``_matmulKernel`` (wrappers
``matmul`` and ``matmulPadded``).  ``matmul(a, b)`` computes (M, K) @ (K, N)
with f32 accumulation and returns the input's type, for f32, bf16 and f16.
Ragged M, N and K are masked inside the kernel, so nothing is padded.  bf16
and f16 run on the tensor cores (WMMA); f32 runs as FFMA, in full f32, since
Hopper's tensor cores have no f32 mode.  Where the output tiles are too few to
fill the card (the serving shapes, M = 32), K is split into slices whose f32
partial tiles a second kernel sums in order; the wrapper allocates them.  What
bounds it and how it is tiled is in the note at the top of
``csrc/matmul.cu``.

``plain`` is the same function in plain PyTorch.  ``matmul`` takes it for
tensors on the CPU, where no kernel can run; for CUDA tensors it launches the
kernel or raises.  ``launches`` counts kernel launches, so a run can show that
its products went through the kernel.  The int8 -> int32 variant of the TPU
kernel, which only the int8 serving engine uses, is not ported yet.
"""

import ctypes

import torch

from puzzlelib_tpu_torch.ops.hopper import build


launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def plain(a, b):
    """(M, K) @ (K, N) in f32, returned in ``a``'s type.  Full f32 needs TF32
    off, which ``Config.matmulPrecision = "highest"`` (the default) sets."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def _entries():
    lib = build.load("matmul")

    lib.pl_matmul_splits.argtypes = [ctypes.c_int] * 5
    lib.pl_matmul_splits.restype = ctypes.c_int

    lib.pl_matmul.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.pl_matmul.restype = ctypes.c_int

    return lib.pl_matmul_splits, lib.pl_matmul


def _check(a, b):
    if a.device != b.device:
        raise ValueError("matmul operands on %s and %s" % (a.device, b.device))

    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError("matmul takes (M, K) @ (K, N), got %s @ %s" % (tuple(a.shape), tuple(b.shape)))

    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError("matmul takes two f32, bf16 or f16 matrices of one type, got %s and %s" %
                        (a.dtype, b.dtype))


def matmul(a, b):
    """a (M, K) @ b (K, N) -> (M, N) in a's type, through kernel K1."""
    _check(a, b)

    if a.device.type == "cpu":
        return plain(a, b)

    if a.device.type != "cuda":
        raise ValueError("matmul runs on CUDA or CPU tensors, got %s" % a.device)

    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul takes contiguous row-major operands")

    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)

    if m == 0 or n == 0:
        return out

    vec = k % 8 == 0 and n % 8 == 0 and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    splitsOf, launch = _entries()

    # K slices, each an f32 partial tile that a second kernel sums
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    slices = splitsOf(m, n, k, _DTYPES[a.dtype], sms)
    partial = torch.empty((slices, m, n), dtype=torch.float32, device=a.device) if slices > 1 else None

    with torch.cuda.device(a.device):
        err = launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), 0 if partial is None else partial.data_ptr(),
                     m, n, k, _DTYPES[a.dtype], int(vec), slices, torch.cuda.current_stream(a.device).cuda_stream)

    if err != 0:
        raise RuntimeError("matmul kernel launch failed for %s @ %s %s: cudaError %d" %
                           (tuple(a.shape), tuple(b.shape), a.dtype, err))

    global launches
    launches += 1
    return out
