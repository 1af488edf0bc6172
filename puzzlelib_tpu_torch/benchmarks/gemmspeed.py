"""GEMM benchmark: kernel K1 against cuBLAS, in f32, bf16, f16 and int8
(counterpart of ``puzzlelib_tpu/benchmarks/gemmspeed.py``).

Run:  python3 -m puzzlelib_tpu_torch.benchmarks.gemmspeed [--sizes 1024,2048,4096]
          [--dtypes float32,bfloat16,float16,int8] [--iters 20] [--kernel-rate] [--tune] [--device cpu]

For each square size and type it times the library's product
(``torch.matmul``; ``torch._int_mm`` for int8) and K1 (``ops/hopper/matmul``;
K1-int8 for int8, through ``matmulNT`` on B laid out once as the K-major
table B^T, as the int8 engine holds its weights) on the same operands and
prints TFLOP/s (TOP/s for int8)
and, on the card, the share of the H100 SXM's data-sheet peak
(``tools/timing.py``: 67 TFLOP/s f32 outside the tensor cores, since TF32
stays off; 989 bf16 and f16; 1979 int8).  Times on the card are the
device's, by CUDA events behind a device sleep, after a line with the card's
name and power limit; with ``--device cpu`` they are the CPU's by the host
clock, and K1 runs its plain version there.

``--kernel-rate`` times the one (8192, 65536) @ (65536, 8192) product in bf16
and in int8 on operands made on the card (``gemmspeed.py:33-98``): at K =
65536 the operands' 1-2 GB are read in a small share of the time of 8.8
TFLOP of tensor-core work, so it measures the kernels' sustained rate.

``--tune`` races K1 against cuBLAS at each size and type (not int8) through
``ops.hopper.matmul.tuneDispatch`` and writes the winner into the table that
``Config.gemmAlgo = "auto"`` reads, as the reference does
(``gemmspeed.py:157-177``; its Pallas tile sweep has no counterpart, since
K1's path follows from the shape): one line each with K1's and cuBLAS's ms
and the choice; on the CPU nothing is raced.  Without ``--device cpu`` the
script needs a card and raises ``DeviceError`` where there is none.
"""

import argparse

import torch

from puzzlelib_tpu_torch.tools.timing import BF16_FLOP_PER_S, F32_FLOP_PER_S, INT8_OP_PER_S, cardName, timeMs


PEAKS = {"float32": F32_FLOP_PER_S, "bfloat16": BF16_FLOP_PER_S, "float16": BF16_FLOP_PER_S, "int8": INT8_OP_PER_S}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16, "int8": torch.int8}


def operands(m, k, n, dtname, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    if dtname == "int8":
        return (torch.randint(-127, 128, (m, k), generator=gen, device=device, dtype=torch.int8),
                torch.randint(-127, 128, (k, n), generator=gen, device=device, dtype=torch.int8))

    a = torch.randn((m, k), generator=gen, device=device).to(DTYPES[dtname])
    b = (torch.randn((k, n), generator=gen, device=device) / k ** 0.5).to(DTYPES[dtname])
    return a, b


def library(a, b):
    return torch._int_mm(a, b) if a.dtype == torch.int8 else torch.matmul(a, b)


def kernelCall(a, b):
    """K1's call on a and b: for int8 ``matmulNT`` on B^T, laid out here,
    before any timing."""
    from puzzlelib_tpu_torch.ops.hopper import matmul

    if a.dtype == torch.int8:
        bt = b.t().contiguous()
        return lambda: matmul.matmulNT(a, bt)

    return lambda: matmul.matmul(a, b)


def _rate(ops, ms, dtname, device):
    rate = ops / ms / 1e9
    unit = "TOP/s" if dtname == "int8" else "TF/s"
    if device.type != "cuda":
        return "%9.4g %s (cpu)" % (rate, unit)

    return "%8.2f %s (%5.1f%% peak)" % (rate, unit, rate / PEAKS[dtname] * 1e14)


def tune(size, dtname, iters):
    """Race K1 against cuBLAS at size^3 and record the winner for "auto",
    anew where the table held one: (choice, K1 ms, cuBLAS ms), None on the
    CPU."""
    from puzzlelib_tpu_torch.ops.hopper import matmul

    dtype = DTYPES[dtname]
    key = matmul.dispatchKey(size, size, size, dtype)
    matmul._dispatch.pop(key, None)

    choice = matmul.tuneDispatch(size, size, size, dtype, iters=iters)
    if choice is None:
        print("    dispatch: not raced (no card)")
        return None

    handMs, libMs = matmul._raceMs[key]
    print("    dispatch -> %s (K1 %.4f ms, cuBLAS %.4f ms)" % (choice, handMs, libMs))
    return choice, handMs, libMs


def sweep(sizes, dtnames, iters, device, tuning=False):
    """One line per (size, type): the library's and K1's rates; with
    ``tuning``, the race's line after each (not int8)."""
    results = {}
    for size in sizes:
        for dtname in dtnames:
            a, b = operands(size, size, size, dtname, device)
            ops = 2.0 * size ** 3

            libMs = timeMs(lambda: library(a, b), iters, device)
            kernelMs = timeMs(kernelCall(a, b), iters, device)
            results[(size, dtname)] = (libMs, kernelMs)

            label = "torch._int_mm" if dtname == "int8" else "torch.matmul "
            kernel = "K1-int8" if dtname == "int8" else "K1     "
            print("%5d %8s | %s %s | %s %s | K1 time / library's %.2fx" %
                  (size, dtname, label, _rate(ops, libMs, dtname, device), kernel, _rate(ops, kernelMs, dtname, device),
                   kernelMs / libMs))

            if tuning and dtname != "int8":
                tune(size, dtname, iters)

    return results


def kernelRate(iters, device):
    """The sustained rate of one (8192, 65536) @ (65536, 8192) product, bf16
    and int8, library and K1, on operands made on the card."""
    m, k, n = 8192, 65536, 8192
    ops = 2.0 * m * n * k

    results = {}
    for dtname in ("bfloat16", "int8"):
        a, b = operands(m, k, n, dtname, device)
        for label, fn in (("library", lambda: library(a, b)), ("K1", kernelCall(a, b))):
            ms = timeMs(fn, iters, device)
            results[(dtname, label)] = ms
            print("kernel-rate %dx%dx%d %-8s | %-7s %s" % (m, k, n, dtname, label, _rate(ops, ms, dtname, device)))
        del a, b

    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sizes", default="1024,2048,4096")
    parser.add_argument("--dtypes", default="float32,bfloat16")
    parser.add_argument("--kernel-rate", action="store_true",
                        help="the huge-K single-GEMM sustained rate, bf16 and int8 (the card only)")
    parser.add_argument("--tune", action="store_true",
                        help="race K1 against cuBLAS at each size and record the winner for gemmAlgo='auto'")
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

    if args.kernel_rate:
        if device.type != "cuda":
            raise SystemExit("--kernel-rate measures the card (its operands take 3 GB)")
        return kernelRate(max(2, args.iters // 5), device)

    dtnames = args.dtypes.split(",")
    unknown = [name for name in dtnames if name not in DTYPES]
    if unknown:
        raise SystemExit("unknown --dtypes %s (from %s)" % (",".join(unknown), ",".join(DTYPES)))

    return sweep([int(s) for s in args.sizes.split(",")], dtnames, args.iters, device, args.tune)


if __name__ == "__main__":
    main()
