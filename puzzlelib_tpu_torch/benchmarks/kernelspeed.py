"""Kernel micro-benchmarks: upsample, matvec / matsum and the batched product
(counterpart of ``puzzlelib_tpu/benchmarks/kernelspeed.py``).

Run:  python3 -m puzzlelib_tpu_torch.benchmarks.kernelspeed [--iters 20] [--device cpu]

Times the reference's calls at the reference's shapes through the port's
backend (``backend.kernels.upsample``, ``backend.kernels.matvec``,
``backend.blas``), f32: nearest upsampling in 2-d and 3-d, the broadcast add
of a vector to a 4096 x 4096 matrix, its column sums, and the grouped
product of 16 x (512 x 512) and 64 x (256 x 256).  Each line gives ms and
the rate on the bytes or operations the call needs.  The reference's argmax
has no counterpart in the port's matvec and is not timed.  Times on the card
are the device's, by CUDA events behind a device sleep, after the card's
name and power limit; with ``--device cpu`` they are the CPU's.  Without
``--device cpu`` the script needs a card and raises ``DeviceError`` where
there is none.
"""

import argparse

import torch

from puzzlelib_tpu_torch.tools.timing import cardName, timeMs


def _randn(shape, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device)


def _line(what, ms, rate, unit, device):
    where = "" if device.type == "cuda" else " (cpu)"
    print("%-40s %9.4f ms  %9.2f %s%s" % (what, ms, rate, unit, where))


def benchUpsample(iters, device):
    from puzzlelib_tpu_torch.backend.kernels import upsample

    results = {}
    for nd, shape, scale in ((2, (32, 16, 64, 64), 2), (3, (16, 8, 16, 32, 32), 2)):
        data = _randn(shape, device, nd)
        fn = upsample.upsample2d if nd == 2 else upsample.upsample3d
        out = fn(data, scale, mode="nearest")

        ms = results["upsample%dd" % nd] = timeMs(lambda: fn(data, scale, mode="nearest"), iters, device)
        nbytes = (data.numel() + out.numel()) * data.element_size()
        _line("upsample%dd nearest %s x%d" % (nd, shape, scale), ms, nbytes / ms / 1e6, "GB/s", device)

    return results


def benchMatVec(iters, device):
    from puzzlelib_tpu_torch.backend import blas as Blas
    from puzzlelib_tpu_torch.backend.kernels import matvec

    A, v = _randn((4096, 4096), device, 3), _randn((4096, ), device, 4)
    nbytes = A.numel() * A.element_size()

    out = matvec.addVecToMat(v, A, axis=1)
    ms = timeMs(lambda: matvec.addVecToMat(v, A, axis=1, out=out), iters, device)
    _line("addVecToMat 4096x4096", ms, 2 * nbytes / ms / 1e6, "GB/s", device)

    outsum = Blas.sumOnMatrix(A, cols=True)
    sumMs = timeMs(lambda: Blas.sumOnMatrix(A, out=outsum, cols=True), iters, device)
    _line("matsum cols 4096x4096", sumMs, nbytes / sumMs / 1e6, "GB/s", device)

    return {"addVecToMat": ms, "matsum": sumMs}


def benchBatchedGemm(iters, device):
    from puzzlelib_tpu_torch.backend import blas as Blas

    results = {}
    for groups, size in ((16, 512), (64, 256)):
        A, B = _randn((groups, size, size), device, 5), _randn((groups, size, size), device, 6)

        ms = results[groups, size] = timeMs(
            lambda: Blas.mulTensorBatch(A, B, formatA="gbp", formatB="gbp", formatOut="gbp"), iters, device)
        _line("batched gemm %dx(%dx%d)" % (groups, size, size), ms, 2 * groups * size ** 3 / ms / 1e9, "TFLOP/s",
              device)

    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--device", default=None, help="cpu to run on the CPU; default the card")
    args = parser.parse_args(argv)

    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.backend.device import getDevice

    if args.device is not None:
        Config.device = args.device
    device = getDevice()

    if device.type == "cuda":
        print(cardName())

    results = benchUpsample(args.iters, device)
    results.update(benchMatVec(args.iters, device))
    results.update(benchBatchedGemm(args.iters, device))
    return results


if __name__ == "__main__":
    main()
