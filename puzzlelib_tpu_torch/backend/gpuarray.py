"""Host <-> device transfers and the supported dtypes.

The reference wraps every array in ``GPUArray`` (``puzzlelib_tpu/tensor.py``);
the port uses plain ``torch.Tensor``s, so what remains here is moving numpy
arrays to the device and back.  numpy has no bfloat16: a bf16 upload goes
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


def to_gpu(ary, dtype=None, device=None):
    """numpy -> tensor on ``device`` (default: the configured one), cast to
    ``dtype`` on the device when given.  The tensor never shares memory with
    ``ary``."""
    device = getDevice() if device is None else torch.device(device)
    host = np.ascontiguousarray(ary)

    if device.type == "cpu" or not host.flags.writeable:
        host = host.copy()

    tensor = torch.from_numpy(host).to(device)
    return tensor if dtype is None else tensor.to(dtype)


def get(tensor):
    """tensor -> numpy on the host; bf16 comes back as float32."""
    tensor = tensor.detach()

    if tensor.dtype == torch.bfloat16:
        tensor = tensor.float()

    return tensor.cpu().numpy()
