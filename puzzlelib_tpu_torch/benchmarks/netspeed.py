"""Full-network train / infer throughput (counterpart of
``puzzlelib_tpu/benchmarks/netspeed.py``).

Run:  python3 -m puzzlelib_tpu_torch.benchmarks.netspeed --net vgg16 --batch 32
      python3 -m puzzlelib_tpu_torch.benchmarks.netspeed --net resnet50 --dtype bfloat16 [--infer] [--many K]

``--net`` names a builder of the zoo (``vgg11`` / ``vgg16`` / ``vgg19``,
``resnet50`` / ``resnet101`` / ``resnet152``, ``nin``, ``lenet``), built with
the builders' default "none" scheme: the weights are whatever the device
memory held, which suits timing only.  The input is one seeded batch of
random images.  Training times one ``FusedStep`` (``CrossEntropy`` and
``MomentumSGD(0.01, 0.9)`` in local state, as the reference sets it up): one
replay of its CUDA graph a step on the card.  ``--infer`` times the eager
eval-mode forward.  Each timed loop is fenced by ``torch.cuda.synchronize()``
(the reference reads a buffer back, its relay's only fence).  ``--many K``
times ``FusedStep.many`` over K and 2K steps, the best of 3 each, and takes
the difference over K, the per-step time without the per-call cost, as the
reference does.

The line printed is the reference's: ms a step and images/s, after the
card's name and power limit.  It runs on the card unless the caller sets
``Config.device`` to the CPU (as the tests do), and raises ``DeviceError``
where there is no card.  ``--profile`` then prints the per-layer table of
``benchmarks/layerprofile`` (forward, backward-data and backward-params ms
of each leaf, the rate, the share of the step timed above and the route
each leaf took).
"""

import argparse
import time

import numpy as np


def buildNet(name, initscheme="none"):
    """(net, image shape, classes) of the zoo net ``name``, its weights drawn
    by ``initscheme`` (the builders' "none": uninitialised memory)."""
    if name.startswith("vgg"):
        from puzzlelib_tpu_torch.models.nets.vgg import loadVGG
        return loadVGG(None, name[3:], initscheme=initscheme), (3, 224, 224), 1000

    if name.startswith("resnet"):
        from puzzlelib_tpu_torch.models.nets.resnet import loadResNet
        return loadResNet(None, name[6:], initscheme=initscheme), (3, 224, 224), 1000

    if name == "nin":
        from puzzlelib_tpu_torch.models.nets.nin import loadNiNImageNet
        return loadNiNImageNet(None, initscheme=initscheme), (3, 224, 224), 1000

    if name == "lenet":
        from puzzlelib_tpu_torch.models.nets.lenet import loadLeNet
        return loadLeNet(None, initscheme=initscheme), (1, 28, 28), 10

    raise ValueError("unknown net %s" % name)


def _parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--net", default="vgg16")
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--dtype", default="float32", choices=["float32", "float16", "bfloat16"])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--many", type=int, default=0, metavar="K",
                        help="per-step time via FusedStep.many: run K and 2K steps in single calls and "
                             "difference them")
    parser.add_argument("--infer", action="store_true", help="time inference instead of training")
    parser.add_argument("--profile", action="store_true", help="per-layer fwd/bwd table after the timing")
    return parser


def main(argv=None):
    """Time one net as the arguments say; returns {"net", "mode", "dtype",
    "batch", "secs"} of the line printed (``secs`` a step)."""
    args = _parser().parse_args(argv)

    import torch

    from puzzlelib_tpu_torch.backend import gpuarray
    from puzzlelib_tpu_torch.backend.device import getDevice, synchronize
    from puzzlelib_tpu_torch.cost import CrossEntropy
    from puzzlelib_tpu_torch.fused import FusedStep
    from puzzlelib_tpu_torch.optimizers import MomentumSGD
    from puzzlelib_tpu_torch.tools.timing import cardName

    device = getDevice()
    if device.type == "cuda":
        print(cardName())

    dtype = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}[args.dtype]

    net, inshape, nlabels = buildNet(args.net)
    if args.dtype != "float32":
        net.calcMode(dtype)

    data = np.random.randn(args.batch, *inshape).astype(np.float32)
    labels = np.random.randint(0, nlabels, size=(args.batch, )).astype(np.int32)
    devData, devLabels = gpuarray.to_gpu(data, dtype=dtype), gpuarray.to_gpu(labels)

    if args.infer:
        net.evalMode()

        net(devData)
        synchronize()

        start = time.perf_counter()
        for _ in range(args.iters):
            net(devData)
        synchronize()
        secs = (time.perf_counter() - start) / args.iters
        mode = "infer"

    else:
        # per-variable state, as the reference sets it up, so that both
        # benchmarks time the same step
        optimizer = MomentumSGD(learnRate=0.01, momRate=0.9)
        optimizer.setupOn(net, useGlobalState=False)
        step = FusedStep(net, CrossEntropy(maxlabels=nlabels), optimizer)

        if args.many:
            k = args.many
            stacked = devData.unsqueeze(0).expand((2 * k, ) + tuple(devData.shape)).contiguous()
            stackedLabels = devLabels.unsqueeze(0).expand(2 * k, args.batch).contiguous()

            def run(steps):
                step.many(stacked[:steps], stackedLabels[:steps], steps)
                synchronize()

            run(k)
            run(2 * k)

            def minTime(steps, tries=3):
                best = float("inf")
                for _ in range(tries):
                    start = time.perf_counter()
                    run(steps)
                    best = min(best, time.perf_counter() - start)
                return best

            once = minTime(k)
            secs = (minTime(2 * k) - once) / k
            mode = "train(many-marginal)"

        else:
            step(devData, devLabels)
            synchronize()

            start = time.perf_counter()
            for _ in range(args.iters):
                step(devData, devLabels)
            synchronize()
            secs = (time.perf_counter() - start) / args.iters
            mode = "train"

    print("%s %s %s batch %d: %.2f ms/step, %.1f images/sec" %
          (args.net, mode, args.dtype, args.batch, secs * 1e3, args.batch / secs))

    if args.profile:
        from puzzlelib_tpu_torch.benchmarks.layerprofile import profileNet
        profileNet(net, devData, stepSecs=None if args.infer else secs)

    return {"net": args.net, "mode": mode, "dtype": args.dtype, "batch": args.batch, "secs": secs}


if __name__ == "__main__":
    main()
