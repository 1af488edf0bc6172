"""Host <-> device transfers, the supported dtypes, and the optimizers'
shared flat buffers (``SharedArray``).

The reference wraps every array in ``GPUArray`` (``puzzlelib_tpu/tensor.py``);
the port uses plain ``torch.Tensor``s, so what remains here is moving numpy
arrays to the device and back, and the allocators ``empty`` and ``zeros``.
The three report to the allocation tracer (``profiler.startTraceMalloc``).  numpy has no bfloat16: a bf16 upload goes
through float32 (which holds every bf16 value exactly) and a bf16 download
comes back as float32.
"""

import numpy as np
import torch

from puzzlelib_tpu_torch.backend.device import getDevice


def dtypesSupported():
    """(dtype, test tolerance) pairs, the reference's per-dtype tiers."""
    return [(torch.float32, 1e-5), (torch.float16, 1e-2), (torch.bfloat16, 5e-2)]


def toTorchDtype(T):
    """A torch dtype from a torch or numpy one (numpy has no bfloat16)."""
    if isinstance(T, torch.dtype):
        return T

    return torch.from_numpy(np.empty(0, dtype=T)).dtype


def toNumpyDtype(T):
    """The numpy dtype a tensor of type T comes back to the host as."""
    return np.float32 if T == torch.bfloat16 else torch.empty(0, dtype=T).numpy().dtype


def _traceAlloc(tensor):
    """The allocation tracer's hook (``profiler.startTraceMalloc``): records
    ``tensor`` while it is on, as the reference's allocators do."""
    from puzzlelib_tpu_torch import profiler

    if profiler.tracingAllocs:
        profiler.recordAlloc(tensor)

    return tensor


def to_gpu(ary, dtype=None, device=None):
    """numpy -> tensor on ``device`` (default: the configured one), cast to
    ``dtype`` on the device when given.  The tensor never shares memory with
    ``ary``."""
    device = getDevice() if device is None else torch.device(device)
    host = np.ascontiguousarray(ary)

    if device.type == "cpu" or not host.flags.writeable:
        host = host.copy()

    tensor = torch.from_numpy(host).to(device)
    return _traceAlloc(tensor if dtype is None else tensor.to(dtype))


def empty(shape, dtype=np.float32, device=None):
    """An uninitialised tensor of ``shape`` on ``device`` (default: the
    configured one)."""
    device = getDevice() if device is None else torch.device(device)
    return _traceAlloc(torch.empty(shape, dtype=toTorchDtype(dtype), device=device))


def zeros(shape, dtype=np.float32, device=None):
    """A zero tensor of ``shape`` on ``device`` (default: the configured one)."""
    device = getDevice() if device is None else torch.device(device)
    return _traceAlloc(torch.zeros(shape, dtype=toTorchDtype(dtype), device=device))


class SharedArray:
    """One flat tensor per dtype with named views (counterpart of the
    reference's ``SharedArray``, ``puzzlelib_tpu/tensor.py``).

    An optimizer in global state registers every parameter (or gradient) of a
    dtype, ``build`` allocates one zeroed flat tensor, and ``sh[name]`` is a
    view of its block (``flat[off:off + n].view(shape)``).  A write to a view
    is a write to the flat tensor, so one update over the flat tensor updates
    every parameter.  Blocks start on 16-byte boundaries, as in the
    reference."""

    GROUP_SIZE = 16

    def __init__(self, dtype=torch.float32, device=None):
        self.dtype = toTorchDtype(dtype)
        self.device = getDevice() if device is None else torch.device(device)

        self.blocks = {}
        self.ary = None
        self._offsets = {}

    def register(self, shape, dtype, name):
        if toTorchDtype(dtype) != self.dtype:
            raise ValueError("SharedArray dtype mismatch: %s vs %s" % (dtype, self.dtype))

        if name in self.blocks:
            raise ValueError("Block %r is already registered" % name)

        self.blocks[name] = (shape, ) if isinstance(shape, int) else tuple(shape)

    def align(self, nelems):
        grain = max(1, self.GROUP_SIZE // self.dtype.itemsize)
        return -(-nelems // grain) * grain

    def build(self):
        offset = 0
        for name, shape in self.blocks.items():
            size = int(np.prod(shape, dtype=np.int64))
            self._offsets[name] = (offset, size, shape)
            offset += self.align(size)

        self.ary = torch.zeros(offset, dtype=self.dtype, device=self.device)

    def __getitem__(self, name):
        offset, size, shape = self._offsets[name]
        return self.ary[offset:offset + size].view(shape)


def get(tensor):
    """tensor -> numpy on the host; bf16 comes back as float32."""
    tensor = tensor.detach()

    if tensor.dtype == torch.bfloat16:
        tensor = tensor.float()

    return tensor.cpu().numpy()
