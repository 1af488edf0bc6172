"""Where the device time of the ResNet-50 slice goes, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 -m puzzlelib_tpu_torch.tools.profileresnet

Builds the run of ``tools/resnetslice.py`` (ResNet-50 in bf16 at batch 32,
``MomentumSGD`` in global state) and, on the hand route, the fused route
and the library route, serves 4 requests of 32 and trains 4 steps of 32,
each once to warm up and once under ``torch.profiler``; prints for each
run the wall time of the profiled run, the device's busy time, the idle
share, the device time by kernel name (``profiletransformer._profile``),
and of that run the device time of the hand kernels, of the batch norms'
and other PyTorch elementwise and reduction kernels, and of the rest
(cuDNN, cuBLAS, copies).  ``chip_smoke.py`` [resnet50] gives the routes'
throughput outside the profiler and the kernels' times at these shapes.
"""

import torch

from puzzlelib_tpu_torch.tools import resnetslice as Res
from puzzlelib_tpu_torch.tools.profiletransformer import KERNELS, _profile
from puzzlelib_tpu_torch.tools.timing import cardName


REQUESTS, STEPS = 4, 4

# the PyTorch kernels by the names the profiler gives them: elementwise
# passes, reductions and casts (the batch norms' f32 passes are most of them)
TORCH_OPS = ("elementwise", "reduce_kernel", "Reduce", "vectorized", "CatArrayBatched")


def _split(events):
    """Device microseconds of (the hand kernels, PyTorch's elementwise and
    reduction kernels, the rest)."""
    hand = ops = rest = 0.0
    for e in events:
        us = e.time_range.elapsed_us()
        if any(name in e.name for names in KERNELS.values() for name in names):
            hand += us
        elif any(name in e.name for name in TORCH_OPS):
            ops += us
        else:
            rest += us

    return hand, ops, rest


def _run(run, label):
    hand, ops, rest = _split(_profile(run, label))
    print("[profile] %s: hand kernels %.1f us, PyTorch elementwise and reductions %.1f us, the rest (cuDNN, cuBLAS, "
          "copies) %.1f us" % (label, hand, ops, rest))


def profileRoutes(run, images, labels, name, batch):
    """REQUESTS requests served and a step trained on each batch of
    ``images`` (STEPS of them) on each route of ``run`` (a
    ``resnetslice.Run``), each once to warm up and once profiled
    (``_run``)."""
    served = images[:batch * REQUESTS]
    routes = (("hopper", "hand kernels"), ("fused", "fused"), ("torch", "library route"))
    for algo, _ in routes:
        run.serve(algo, served)
        run.train(algo, images, labels)

    for algo, label in routes:
        _run(lambda: run.serve(algo, served)[1], "%s serving %d requests of %d, %s" % (name, REQUESTS, batch, label))

    for algo, label in routes:
        _run(lambda: run.train(algo, images, labels), "%s training %d steps of %d, %s" %
             (name, len(images) // batch, batch, label))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile needs an NVIDIA GPU")

    from puzzlelib_tpu_torch import config as Config

    print(cardName())
    Config.device = "cuda"
    profileRoutes(Res.buildRun(), *Res.data(Res.BATCH * STEPS), "ResNet-50", Res.BATCH)


if __name__ == "__main__":
    main()
