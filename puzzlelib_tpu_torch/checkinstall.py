"""Environment probe (counterpart of ``puzzlelib_tpu/checkinstall.py``).

Checks that the port's device answers, that the hand kernels build and run
on it, and that core numeric paths agree with numpy:

- the device: its name and, on a card, its power limit (``nvidia-smi``);
- the GEMM probe: ``Blas.mulMatrixOnMatrix`` of a 64 x 64 f32 matrix (on
  the card, kernel K1 in f32) against numpy;
- the conv probe: ``Dnn.convNd`` of a (2, 3, 16, 16) batch;
- the kernel probe: K0 (``ops/hopper/probe.py``) doubles an (8, 128) f32
  block, compared exactly with its plain ``x * 2``.

Unlike the reference, which reports an unavailable Pallas probe and goes
on, a failed build or launch raises and the script exits non-zero.  Run it
as ``python3 -m puzzlelib_tpu_torch.checkinstall`` (on the card, or with
``Config.device = "cpu"`` set by a caller, on the CPU).
"""

import subprocess

import numpy as np
import torch


# the GEMM probe's bound on max |out - numpy| / max |numpy|: K1 in f32 sums
# 64 products in another order than numpy (~sqrt(64) f32 ulps, 5e-7)
GEMM_BOUND = 1e-4


def _cardLine(device):
    if device.type != "cuda":
        return "none (the CPU)"

    query = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    if query.returncode != 0 or not query.stdout.strip():
        raise RuntimeError("nvidia-smi gave no card name and power limit: %s" % query.stderr.strip())

    return query.stdout.strip().splitlines()[device.index or 0].strip()


def main():
    """Run the probes and print one line each; returns the GEMM probe's
    relative error and K0's largest difference from its plain version."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.backend import blas as Blas, dnn as Dnn, gpuarray
    from puzzlelib_tpu_torch.backend.device import getDevice, getDeviceName
    from puzzlelib_tpu_torch.ops.hopper import probe

    device = getDevice()
    print("Device: %s (Config.device %s; torch %s, CUDA %s)" %
          (getDeviceName(device), Config.device, torch.__version__, torch.version.cuda))
    print("Card, power limit: %s" % _cardLine(device))

    rng = np.random.RandomState(0)

    x = rng.randn(64, 64).astype(np.float32)
    y = gpuarray.get(Blas.mulMatrixOnMatrix(gpuarray.to_gpu(x), gpuarray.to_gpu(x)))
    want = x.astype(np.float64) @ x.astype(np.float64)
    gemmErr = float(np.abs(y - want).max() / np.abs(want).max())

    if not gemmErr <= GEMM_BOUND:
        raise RuntimeError("GEMM probe: relative error %.3e above %.0e" % (gemmErr, GEMM_BOUND))
    print("GEMM probe: ok (relative error %.3e)" % gemmErr)

    data = gpuarray.to_gpu(rng.randn(2, 3, 16, 16).astype(np.float32))
    W = gpuarray.to_gpu(rng.randn(4, 3, 3, 3).astype(np.float32))
    out = Dnn.convNd(data, W, None, (1, 1), (1, 1), (1, 1), 1)
    if tuple(out.shape) != (2, 4, 16, 16) or not bool(torch.isfinite(out).all()):
        raise RuntimeError("Conv probe: output of shape %s, finite %s" %
                           (tuple(out.shape), bool(torch.isfinite(out).all())))
    print("Conv probe: ok")

    block = gpuarray.to_gpu(rng.randn(8, 128).astype(np.float32))
    probeErr = (probe.double(block) - probe.plain(block)).abs().max().item()
    if probeErr != 0.0:
        raise RuntimeError("Kernel probe (K0): differs from x * 2 by %.3e" % probeErr)
    print("Kernel probe (K0): ok")

    print("Install check passed")
    return {"gemm_rel_err": gemmErr, "probe_abs_err": probeErr}


if __name__ == "__main__":
    main()
