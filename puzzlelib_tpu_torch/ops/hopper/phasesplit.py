"""Probe P2: the stride-2 phase-slab copy, hand-written in CUDA C++
(``csrc/phasesplit.cu``).

Replaces ``tools/strided_dma_probe.py`` ``_kernel`` (through ``phaseSplit``),
the Pallas kernel that asks whether the TPU's DMA engine can copy the four
stride-2 phases of an NHWC image straight out of device memory.
``phaseSplit(x6, rows, tw, c, nTiles)`` takes x6, the free reshape (N, H/2,
2, W/2, 2, C) of an NHWC image, and returns (nTiles, 4, rows, W/2, C) with

    out[t, 2 ap + bp, r, j, :] = x6[0, t rows + r, ap, j, bp, :]

Like the TPU kernel it reads batch 0 only (``xRef.at[0, ...]``): the other
images of x6 are not copied.  The copy is exact in any type; on the card C
times the element size is a multiple of 16 bytes.  What bounds it
(the bytes) and how it gathers is in the note at the top of the source.

``plain`` is the same copy in plain PyTorch, the permuted ``.contiguous()``
of x6's first image, which is also the library's way to do it.
``phaseSplit`` takes it for tensors on the CPU, where no kernel can run; for
CUDA tensors it launches the kernel or raises.  ``launches`` counts kernel
launches.
"""

import ctypes

import torch

from puzzlelib_tpu_torch.ops.hopper import build


launches = 0


def _check(x6, rows, tw, c, nTiles):
    if x6.dim() != 6 or x6.shape[2] != 2 or x6.shape[4] != 2 or x6.shape[3] != tw or x6.shape[5] != c:
        raise ValueError("phaseSplit takes x6 (N, H/2, 2, tw, 2, c) with tw = %d and c = %d, got %s" %
                         (tw, c, tuple(x6.shape)))

    if x6.shape[0] < 1 or rows < 1 or nTiles < 0 or nTiles * rows > x6.shape[1]:
        raise ValueError("phaseSplit copies %d tiles of %d rows from the %d rows of x6's first image" %
                         (nTiles, rows, x6.shape[1]))


def plain(x6, rows, tw, c, nTiles):
    """The copy in plain PyTorch: x6's first image, its first nTiles * rows
    rows, permuted to (tile, ap, bp, row, column, channel)."""
    _check(x6, rows, tw, c, nTiles)

    tiles = x6[0, :nTiles * rows].reshape(nTiles, rows, 2, tw, 2, c)
    return tiles.permute(0, 2, 4, 1, 3, 5).reshape(nTiles, 4, rows, tw, c).contiguous()


def _entry():
    fn = build.load("phasesplit").pl_phase_split
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def phaseSplit(x6, rows, tw, c, nTiles):
    """(nTiles, 4, rows, tw, c): the stride-2 phase slabs of x6's first
    image, through probe kernel P2."""
    _check(x6, rows, tw, c, nTiles)

    if x6.device.type == "cpu":
        return plain(x6, rows, tw, c, nTiles)

    if x6.device.type != "cuda":
        raise ValueError("the phase-split kernel runs on CUDA or CPU tensors, got %s" % x6.device)

    x6 = x6.contiguous()
    out = torch.empty((nTiles, 4, rows, tw, c), dtype=x6.dtype, device=x6.device)
    if out.numel() == 0:
        return out

    # the kernel copies 16-byte units and indexes below 2^31 of them
    rowBytes = c * x6.element_size()
    if rowBytes % 16 or x6.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("the phase-split kernel copies 16-byte units: C x the element size must be a multiple of 16 "
                         "and the operands 16-byte aligned, got C = %d in %s" % (c, x6.dtype))

    if x6[0].numel() * x6.element_size() // 16 >= 2 ** 31:
        raise ValueError("the phase-split kernel indexes below 2^31 units of 16 bytes, got x6 %s %s" %
                         (tuple(x6.shape), x6.dtype))

    with torch.cuda.device(x6.device):
        err = _entry()(x6.data_ptr(), out.data_ptr(), tw, rowBytes, rows, nTiles,
                       torch.cuda.current_stream(x6.device).cuda_stream)

    if err != 0:
        raise RuntimeError("phase-split kernel launch failed for x6 %s %s: cudaError %d" %
                           (tuple(x6.shape), x6.dtype, err))

    global launches
    launches += 1
    return out
