"""Where the device time of the transformer slices goes, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 -m puzzlelib_tpu_torch.tools.profiletransformer

Serves the slice of ``tools/transformerslice.py`` in bf16 on the hand
route, the fused route (``FusedCalculator``) and the library route, then
trains it (4 steps of 64 with Adam) on the hand route, the fused route
(``FusedTrainer(stepsPerDispatch=4)``) and the library route, each once to
warm up and once under ``torch.profiler``, and prints for each run the wall
time of the profiled run, the device's busy time (the union of the kernel
and copy intervals), the idle share, and the device time by kernel name.
``chip_smoke.py`` [transformer], [transformer-train],
[fused-transformer-serve] and [fused-transformer-train] give the routes'
throughput outside the profiler, [K1], [K4] and [K5] the kernels' times at
these shapes.
"""

import torch

from puzzlelib_tpu_torch.tools import transformerslice as Slice
from puzzlelib_tpu_torch.tools.timing import cardName


# the hand kernels by the names the profiler gives their launches: a device
# event is a launch of kernel k where its name holds one of KERNELS[k]
KERNELS = {
    "K1": ("gemmWgmma", "gemmTensorCore", "gemmF32"),
    "K2": ("winogradF23", ),
    "K3": ("winogradFG", ),
    "K4": ("flashForward", ),
    "K5a": ("flashBackwardDq", ),
    "K5b": ("flashBackwardDkv", ),
}


def busyUs(events):
    """The length of the union of the events' intervals, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")

    for start, stop in spans:
        if stop <= end:
            continue
        busy += stop - max(start, end)
        end = stop

    return busy


def profiled(run):
    """(the seconds ``run()`` returns, the device events) of one call of
    ``run`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        secs = run()

    return secs, [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def idleShare(secs, events):
    """1 - the device's busy time over the wall time."""
    return 1.0 - busyUs(events) / (secs * 1e6)


def kernelLaunches(events):
    """{kernel: launches} of the hand kernels among the device events."""
    return {kernel: sum(1 for e in events if any(name in e.name for name in names))
            for kernel, names in KERNELS.items()}


def _profile(run, label, top=25):
    secs, events = profiled(run)
    busy, wall = busyUs(events), secs * 1e6

    print("[profile] %s: wall %.1f us under the profiler, device busy %.1f us, idle %.1f %%, %d device events" %
          (label, wall, busy, 100.0 * idleShare(secs, events), len(events)))

    byName = {}
    for e in events:
        total, count = byName.get(e.name, (0.0, 0))
        byName[e.name] = (total + e.time_range.elapsed_us(), count + 1)

    for name, (total, count) in sorted(byName.items(), key=lambda item: -item[1][0])[:top]:
        print("[profile] %s: %9.1f us %4d x  %s" % (label, total, count, name[:150]))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile needs an NVIDIA GPU")

    print(cardName())

    routes, tokens = Slice.build()
    for net in routes.values():
        net.calcMode(torch.bfloat16)
    routes[Slice.FUSED] = Slice.fusedCalculator(routes)

    for algo in routes:
        Slice.serve(routes, algo, tokens)

    for algo, label in (("hopper", "serving, hand kernels"), (Slice.FUSED, "serving, fused (FusedCalculator)"),
                        ("torch", "serving, library route")):
        _profile(lambda: Slice.serve(routes, algo, tokens)[1], label)

    del routes
    torch.cuda.empty_cache()

    routes, tokens, labels = Slice.buildTraining()
    for algo in ("hopper", Slice.FUSED, "torch"):
        Slice.train(routes, algo, tokens, labels)

    for algo, label in (("hopper", "training, hand kernels"),
                        (Slice.FUSED, "training, fused (FusedTrainer, %d steps a dispatch)" % Slice.STEPS_PER_DISPATCH),
                        ("torch", "training, library route")):
        _profile(lambda: Slice.train(routes, algo, tokens, labels), label)


if __name__ == "__main__":
    main()
