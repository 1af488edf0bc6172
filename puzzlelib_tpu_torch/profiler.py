"""Profiling and tracing (counterpart of ``puzzlelib_tpu/profiler.py``).

``trace(logdir)`` records the enclosed region with ``torch.profiler`` (the
host and, where there is a card, the device's kernels and copies) and writes
a Chrome trace into ``logdir``; ``annotate(name)`` labels a host region in
it.  ``timeKernel`` is the backend's wall-clock timer, fenced by a device
synchronize.

The allocation tracer is the reference's TraceMalloc tier: while
``startTraceMalloc`` is on, every tensor made by the port's allocators
(``backend/gpuarray.py`` ``to_gpu``, ``empty``, ``zeros``) is recorded with
its bytes, shape, type and the first caller outside the package, and a weak
reference's finalizer retires the entry when the tensor dies, so
``liveAllocations()`` is the leak report.  ``deviceMemoryStats()`` is the
caching allocator's statistics of each card.
"""

import contextlib
import os
import traceback
import weakref

import torch

from puzzlelib_tpu_torch.backend.device import timeKernel  # noqa: F401  (public re-export)


@contextlib.contextmanager
def trace(logdir):
    """Record the enclosed region; writes ``logdir/trace.json`` (Chrome
    trace format, for ``chrome://tracing`` or Perfetto) at its end.  Yields
    the ``torch.profiler.profile`` object, whose ``key_averages()`` sums the
    time by operator and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)

    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof

    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name):
    """Label a host region in the trace timeline."""
    return torch.profiler.record_function(name)


# -- the allocation tracer -------------------------------------------------------

_traceAllocs = {}
_traceSeq = 0
tracingAllocs = False


def _callsite():
    for frame in reversed(traceback.extract_stack()):
        if "puzzlelib_tpu_torch" not in (frame.filename or ""):
            return "%s:%d" % (frame.filename, frame.lineno)

    return "<internal>"


def recordAlloc(tensor):
    """Register one live tensor; the allocators call it while
    ``startTraceMalloc`` is on."""
    global _traceSeq

    if not tracingAllocs:
        return

    _traceSeq += 1
    slot = _traceSeq

    _traceAllocs[slot] = (tensor.numel() * tensor.element_size(), tuple(tensor.shape), str(tensor.dtype),
                          _callsite())
    weakref.finalize(tensor, _traceAllocs.pop, slot, None)


def startTraceMalloc():
    """Begin recording allocations (clears any previous record)."""
    global tracingAllocs

    _traceAllocs.clear()
    tracingAllocs = True


def stopTraceMalloc():
    """Stop recording; returns the live-allocation report."""
    global tracingAllocs

    tracingAllocs = False
    return liveAllocations()


def liveAllocations():
    """The live recorded allocations, (bytes, shape, dtype, callsite), the
    largest first."""
    return sorted(_traceAllocs.values(), reverse=True)


def traceLeaks():
    """The number of recorded allocations still alive."""
    return len(_traceAllocs)


def formatAllocReport(top=20):
    lines = ["%10d B  %-18s %-14s %s" % (nbytes, shape, dtype, site)
             for nbytes, shape, dtype, site in liveAllocations()[:top]]
    total = sum(entry[0] for entry in _traceAllocs.values())

    return "\n".join(lines + ["%10d B live in %d allocations" % (total, len(_traceAllocs))])


def deviceMemoryStats():
    """{"cuda:i": ``torch.cuda.memory_stats(i)``} for each card (allocated,
    reserved and peak bytes, allocation counts); empty without a card."""
    if not torch.cuda.is_available():
        return {}

    return {"cuda:%d" % i: torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
