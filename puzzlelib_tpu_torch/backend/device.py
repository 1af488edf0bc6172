"""The explicit device (counterpart of ``puzzlelib_tpu/backend/device.py``).

PyTorch runs eagerly on whatever device a tensor lives on, so the backend
needs no bootstrap beyond choosing that device and pinning f32 precision.
The port runs on the CUDA card unless the caller asks for the CPU with
``Config.device = "cpu"``: with no card and no such request, ``getDevice``
raises instead of running on the CPU unnoticed.  ``timeKernel`` is the
reference's wall-clock kernel timer.
"""

import time

import torch

from puzzlelib_tpu_torch import config as Config


def ensureInit():
    """Apply ``Config.matmulPrecision``: while it is "highest", TF32 stays off
    in cuBLAS and cuDNN, and cuBLAS reduces bf16 and f16 products in f32, as
    the reference's ``preferred_element_type=float32`` products do."""
    relaxed = Config.matmulPrecision != "highest"

    torch.backends.cuda.matmul.allow_tf32 = relaxed
    torch.backends.cudnn.allow_tf32 = relaxed
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = relaxed
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = relaxed


class DeviceError(RuntimeError):
    pass


def getDevice():
    """``Config.device``, or the first CUDA card when it is None; raises
    ``DeviceError`` when it is None and there is no card."""
    ensureInit()

    if Config.device is not None:
        return torch.device(Config.device)

    if not torch.cuda.is_available():
        raise DeviceError("no CUDA device: the port runs on an NVIDIA GPU; set Config.device = \"cpu\" "
                          "(puzzlelib_tpu_torch.config) to run on the CPU")

    return torch.device("cuda")


def getDeviceName(device=None):
    device = getDevice() if device is None else torch.device(device)

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)

    return "cpu"


def synchronize(device=None):
    """Wait for the work queued on a CUDA device; nothing to wait for on the CPU."""
    device = getDevice() if device is None else torch.device(device)

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeKernel(func, args=(), kwargs=None, looplength=1000, log=True, logname=None, normalize=False, hotpass=True):
    """Seconds of ``looplength`` calls of ``func(*args, **kwargs)`` by the
    host clock, each end fenced by ``torch.cuda.synchronize()`` where there
    is a card (the reference's event-timed ``timeKernel``): the total, or the
    mean of one call with ``normalize``.  ``hotpass`` runs one untimed call
    first; ``log`` writes the time to the library's logger under ``logname``
    (default: the function's name).  On the CPU the calls finish before they
    return and there is nothing to fence."""
    kwargs = {} if kwargs is None else kwargs

    def fence():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    if hotpass:
        func(*args, **kwargs)

    fence()
    start = time.perf_counter()

    for _ in range(looplength):
        func(*args, **kwargs)

    fence()
    secs = time.perf_counter() - start

    if normalize:
        secs /= looplength

    if log:
        logname = func.__name__ if logname is None else logname
        Config.getLogger().info("%s time: %s secs", logname, secs)

    return secs
