"""Timing a call on the card by CUDA events, and the least time the card
could take for a piece of work."""

import torch


# the H100 SXM's peaks (NVIDIA's data sheet): dense bf16 and int8 on the
# tensor cores, f32 outside them, and device memory
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12
F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

# about 1 ms of the H100's clock per timed call: the device sleeps that long
# ahead of the timed calls, so the host has queued them all before the device
# reaches the first
SLEEP_CYCLES_PER_CALL = 2_000_000


def deviceMs(fn, iters):
    """Mean milliseconds of the device work of ``fn`` after a warm-up, by CUDA
    events around ``iters`` calls.  A device sleep queued ahead of the timed
    calls keeps the host's launch overhead (the Python wrapper, the library's
    dispatch) out of the measure, as long as one call takes the host less
    than ~1 ms to queue."""
    fn()
    torch.cuda.synchronize()

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()

    return start.elapsed_time(end) / iters


def bound(nbytes, flops, flopPerS=BF16_FLOP_PER_S, f32Flops=0):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move ``nbytes`` through device memory and do ``flops`` operations at
    ``flopPerS`` (bf16 by default), and which of the two binds.  ``f32Flops``
    are further operations in f32 outside the tensor cores (a Winograd
    transform's adds); those units run beside the tensor cores, so the
    operations take the longer of the two."""
    byteMs = nbytes / HBM_BYTES_PER_S * 1e3
    flopMs = max(flops / flopPerS, f32Flops / F32_FLOP_PER_S) * 1e3
    return (byteMs, "bytes") if byteMs >= flopMs else (flopMs, "operations")
