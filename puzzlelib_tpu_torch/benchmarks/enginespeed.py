"""Serving-engine throughput benchmark (counterpart of
``puzzlelib_tpu/benchmarks/enginespeed.py``).

Run:  python3 -m puzzlelib_tpu_torch.benchmarks.enginespeed --net nin --batch 128
      python3 -m puzzlelib_tpu_torch.benchmarks.enginespeed --batch 512 --dtypes float32,int8 [--device cpu]
          [--workdir DIR]

For each type it builds the zoo net's engine (``buildEngine``; int8 with a
``DataCalibrator`` over 64 images, "minmax"), loads it back (``Engine``)
and prints two rates:

  * eager: one call of the engine a batch, on one resident batch;
  * many: one ``Engine.many`` call over K distinct batches resident on the
    device, a (K, batch, ...) stack, the best of 3 calls, per batch.

The net's weights are He-initialised from a seed (``netspeed.buildNet``)
and the batches drawn on the device from a seeded generator.  Every timing
ends in ``torch.cuda.synchronize()`` on the card, whose name and power
limit come first.  The engine runs on the card unless ``--device cpu``; with
no card and no ``--device cpu`` it raises ``DeviceError``.
"""

import argparse
import os
import tempfile
import time

import numpy as np

from puzzlelib_tpu_torch.benchmarks.netspeed import buildNet


def measure(engine, batch, stack, iters, synchronize):
    """(eager secs a batch, many secs a batch) of one engine."""
    engine(batch)
    synchronize()

    start = time.perf_counter()
    for _ in range(iters):
        engine(batch)
    synchronize()
    eager = (time.perf_counter() - start) / iters

    engine.many(stack)
    synchronize()

    best = float("inf")
    for _ in range(3):
        start = time.perf_counter()
        engine.many(stack)
        synchronize()
        best = min(best, time.perf_counter() - start)

    return eager, best / stack.shape[0]


def _parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--net", default="nin")
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--dtypes", default="float32,int8", help="comma list of float32,bfloat16,float16,int8")
    parser.add_argument("--many", type=int, default=8, metavar="K", help="distinct resident batches of Engine.many")
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--device", default=None, help="cpu to run on the CPU; default the card")
    parser.add_argument("--workdir", default=None, help="where the engine files go, in a temporary directory "
                                                         "deleted after the run (default: the system's)")
    return parser


def main(argv=None):
    """Time the engines as the arguments say; returns {dtype: (eager secs,
    many secs)}, a batch each."""
    args = _parser().parse_args(argv)

    import torch

    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.backend.device import getDevice, synchronize
    from puzzlelib_tpu_torch.converter.engine import buildEngine, DataCalibrator, Engine
    from puzzlelib_tpu_torch.tools.timing import cardName

    if args.device is not None:
        Config.device = args.device

    device = getDevice()
    if device.type == "cuda":
        print(cardName())

    np.random.seed(5)
    net, inshape, _ = buildNet(args.net, initscheme="he")

    gen = torch.Generator(device=device).manual_seed(5)
    stack = torch.randn((args.many, args.batch) + inshape, generator=gen, device=device)
    batch = stack[0]
    calibration = stack[0, :min(64, args.batch)].cpu().numpy()

    rates = {}
    with tempfile.TemporaryDirectory(dir=args.workdir) as tmp:
        for dtype in args.dtypes.split(","):
            calibrator = DataCalibrator(calibration, batchsize=16, algo="minmax") if dtype == "int8" else None

            start = time.perf_counter()
            buildEngine(net, inshape=(args.batch, ) + inshape, savepath=tmp, dtype=dtype, name=args.net,
                        calibrator=calibrator, returnEngine=False)
            built = time.perf_counter()
            engine = Engine(os.path.join(tmp, "%s.%s.engine" % (args.net, dtype)))
            loaded = time.perf_counter()

            eager, many = measure(engine, batch, stack, args.iters, synchronize)
            rates[dtype] = (eager, many)

            print("%s serve %s batch %d: eager %.2f ms/batch = %.0f img/s; many(%d distinct batches) %.2f ms/batch "
                  "= %.0f img/s (built in %.1f s, loaded in %.1f s)" %
                  (args.net, dtype, args.batch, eager * 1e3, args.batch / eager, args.many, many * 1e3,
                   args.batch / many, built - start, loaded - built))

    return rates


if __name__ == "__main__":
    main()
