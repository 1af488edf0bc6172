"""Conv benchmark: forward, bwd-data and bwd-filter (counterpart of
``puzzlelib_tpu/benchmarks/convspeed.py``, the reference's ConvSpeed shapes).

Run:  python3 -m puzzlelib_tpu_torch.benchmarks.convspeed [--dtype bfloat16] [--chain]
          [--data 128,32,64,64] [--weights 64,32,11,11] [--pad 0] [--device cpu]

``main`` times the three directions through ``backend.dnn.convNdbenchmark``
on the route ``Config.convAlgo`` selects (K2 and K3 where they take the conv,
cuDNN elsewhere), ``timeKernel``'s host clock fenced by a device
synchronize, and prints seconds and TFLOP/s per direction with the route
that ran.  ``--chain`` is the reference's kernel-rate mode (``chainRate``):
bf16, each direction timed by CUDA events behind a device sleep
(``tools/timing.deviceMs``), with the share of the H100's 989 TFLOP/s.  The
default shape is the file's, an 11x11 conv that no hand kernel takes;
``--data``, ``--weights`` and ``--pad`` choose another (a 3x3 conv with C
and CO multiples of 128 goes to K2 and K3 in bf16).

Both modes first race the hand kernels that take the conv against cuDNN
(``ops.conv.measureAlgoChoice``, which ``convNdbenchmark`` runs) and print
each direction's choice beside the two times it rests on, as the
reference prints its measured dispatch; under ``Config.convAlgo = "auto"``
the times that follow are those of the chosen routes.

On the card every line follows the card's name and power limit; with
``--device cpu`` the times are the CPU's and nothing is raced.  Without
``--device cpu`` the script needs a card and raises ``DeviceError`` where
there is none.
"""

import argparse

import numpy as np
import torch

from puzzlelib_tpu_torch.tools.timing import BF16_FLOP_PER_S, cardName, timeMs


DATASHAPE, WSHAPE = (128, 32, 64, 64), (64, 32, 11, 11)


def _flops(datashape, Wshape, stride, pad):
    n, cin, h, w = datashape
    cout, _, kh, kw = Wshape
    outh = (h + 2 * pad - kh) // stride + 1
    outw = (w + 2 * pad - kw) // stride + 1
    return 2.0 * n * cout * outh * outw * cin * kh * kw, (outh, outw)


def printChoices(datashape, Wshape, stride, pad, dilation):
    """One line a direction raced at this conv: the recorded choice and
    the hand kernel's and the library's ms; returns {direction: (choice,
    hand ms, library ms)}."""
    from puzzlelib_tpu_torch.ops import conv as opsconv

    measured = {}
    for direction, key in opsconv.raceKeys(datashape, Wshape, stride, pad, dilation, 1).items():
        if key in opsconv._algoChoice:
            measured[direction] = (opsconv._algoChoice[key], ) + opsconv._algoMs[key]
            print("measured dispatch %-8s -> %-6s (hand %.4f ms, library %.4f ms)" % ((direction, ) +
                                                                                   measured[direction]))

    return measured


def chainRate(datashape=DATASHAPE, Wshape=WSHAPE, pad=0, iters=20):
    """bf16 forward, bwd-data and bwd-filter of one conv on the configured
    device, each timed alone (``deviceMs`` on the card): {direction: ms}."""
    from puzzlelib_tpu_torch.backend.device import getDevice
    from puzzlelib_tpu_torch.ops import conv as opsconv
    from puzzlelib_tpu_torch.ops.hopper import winograd

    device = getDevice()
    nd = 2
    stride, pads, dilation = (1, ) * nd, (pad, ) * nd, (1, ) * nd
    flops, (outh, outw) = _flops(datashape, Wshape, 1, pad)
    n, cin, h, w = datashape

    gen = torch.Generator(device=device).manual_seed(0)
    x = (torch.randn(datashape, generator=gen, device=device) * 0.1).to(torch.bfloat16)
    wgt = (torch.randn(Wshape, generator=gen, device=device) * 0.1).to(torch.bfloat16)
    grad = (torch.randn((n, Wshape[0], outh, outw), generator=gen, device=device) * 0.1).to(torch.bfloat16)
    x = opsconv.kernelLayout(x, Wshape, stride, pads, dilation, 1)

    # the race first, so that the chains time what a net optimized for the
    # shape runs under "auto"
    opsconv.measureAlgoChoice(datashape, Wshape, stride, pads, dilation, 1)
    printChoices(datashape, Wshape, stride, pads, dilation)

    directions = [
        ("fwd", flops, "launches", lambda: opsconv.convNd(x, wgt, None, stride, pads, dilation, 1)),
        ("bwdData", 2.0 * n * cin * h * w * Wshape[0] * Wshape[2] * Wshape[3], "dataGradLaunches",
         lambda: opsconv.convNdBackwardData(grad, wgt, tuple(x.shape), stride, pads, dilation, 1)),
        ("bwdFilter", flops, "filterGradLaunches",
         lambda: opsconv.convNdBackwardParams(x, grad, wgt, stride, pads, dilation, 1)),
    ]

    results = {}
    for name, ops, counter, fn in directions:
        before = getattr(winograd, counter)
        ms = timeMs(fn, iters, device)
        route = "winograd" if getattr(winograd, counter) > before else "library"
        results[name] = ms

        share = " (%4.1f%% of bf16 peak)" % (ops / ms / 1e9 / BF16_FLOP_PER_S * 1e14) if device.type == "cuda" else ""
        print("%-10s chain %.6f ms  %8.2f TFLOP/s%s  [%s]" % (name, ms, ops / ms / 1e9, share, route))

    return results


def main(datashape=DATASHAPE, Wshape=WSHAPE, stride=1, pad=0, dtype=np.float32):
    from puzzlelib_tpu_torch.backend.dnn import convNdbenchmark

    nd = len(datashape) - 2
    fwdResults, bwdParamsResults, bwdDataResults = convNdbenchmark(
        datashape, Wshape, (stride, ) * nd, (pad, ) * nd, (1, ) * nd, groups=1, dtype=dtype
    )

    flops, _ = _flops(datashape, Wshape, stride, pad)
    print("Benchmarking conv data %s W %s" % (tuple(datashape), tuple(Wshape)))

    printChoices(datashape, Wshape, (stride, ) * nd, (pad, ) * nd, (1, ) * nd)

    for name, results in (("fwd", fwdResults), ("bwdFilter", bwdParamsResults), ("bwdData", bwdDataResults)):
        perf = results[0]
        print("%-10s %.6f secs  %8.2f TFLOP/s  [%s]" % (name, perf.time, flops / perf.time / 1e12, perf.algo.name))

    return fwdResults, bwdParamsResults, bwdDataResults


def _shape(text):
    return tuple(int(v) for v in text.split(","))


def cli(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chain", action="store_true", help="bf16 kernel rates by device events")
    parser.add_argument("--dtype", default="float32", help="float32, float16 or bfloat16")
    parser.add_argument("--data", type=_shape, default=DATASHAPE, help="N,C,H,W")
    parser.add_argument("--weights", type=_shape, default=WSHAPE, help="CO,C,KH,KW")
    parser.add_argument("--pad", type=int, default=0)
    parser.add_argument("--device", default=None, help="cpu to run on the CPU; default the card")
    args = parser.parse_args(argv)

    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.backend.device import getDevice

    if args.device is not None:
        Config.device = args.device
    if getDevice().type == "cuda":
        print(cardName())

    if args.chain:
        return chainRate(args.data, args.weights, args.pad)

    dtype = "bfloat16" if args.dtype == "bfloat16" else np.dtype(args.dtype)
    return main(args.data, args.weights, pad=args.pad, dtype=dtype)


if __name__ == "__main__":
    cli()
