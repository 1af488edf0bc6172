"""Kernel K0: the install probe, hand-written in CUDA C++ (``csrc/probe.cu``).

Replaces ``puzzlelib_tpu/checkinstall.py`` ``kernel``, the Pallas kernel that
doubles one (8, 128) f32 block.  ``double(x)`` returns ``2 x`` for an f32
tensor.  ``plain`` is the same function in plain PyTorch, which ``double``
takes for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.  ``launches`` counts kernel launches.
"""

import ctypes

import torch

from puzzlelib_tpu_torch.ops.hopper import build


launches = 0


def plain(x):
    return x * 2


def _entry():
    fn = build.load("probe").pl_probe_double
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def double(x):
    """2 x for an f32 tensor, through kernel K0."""
    if x.dtype != torch.float32:
        raise TypeError("the probe kernel takes f32, got %s" % x.dtype)

    if x.device.type == "cpu":
        return plain(x)

    if x.device.type != "cuda":
        raise ValueError("the probe kernel runs on CUDA or CPU tensors, got %s" % x.device)

    x = x.contiguous()
    y = torch.empty_like(x)

    with torch.cuda.device(x.device):
        err = _entry()(x.data_ptr(), y.data_ptr(), x.numel(), torch.cuda.current_stream(x.device).cuda_stream)

    if err != 0:
        raise RuntimeError("probe kernel launch failed for %s: cudaError %d" % (tuple(x.shape), err))

    global launches
    launches += 1
    return y
