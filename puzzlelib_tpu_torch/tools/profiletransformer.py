"""Where the device time of the transformer slices goes, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 -m puzzlelib_tpu_torch.tools.profiletransformer

Serves the slice of ``tools/transformerslice.py`` in bf16 on both routes,
then trains it (4 steps of 64 with Adam) on both routes, each once to warm
up and once under ``torch.profiler``, and prints for each run the wall time
of the profiled run, the device's busy time (the union of the kernel and
copy intervals), the idle share, and the device time by kernel name.
``chip_smoke.py`` [transformer] and [transformer-train] give the routes'
throughput outside the profiler, [K1], [K4] and [K5] the kernels' times at
these shapes.
"""

import torch

from puzzlelib_tpu_torch.tools import transformerslice as Slice
from puzzlelib_tpu_torch.tools.timing import cardName


def _busyUs(events):
    """The length of the union of the events' intervals, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")

    for start, stop in spans:
        if stop <= end:
            continue
        busy += stop - max(start, end)
        end = stop

    return busy


def _profile(serve, label, top=25):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        secs = serve()

    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busyUs(events)
    wall = secs * 1e6

    print("[profile] %s: wall %.1f us under the profiler, device busy %.1f us, idle %.1f %%, %d device events" %
          (label, wall, busy, 100.0 * (1.0 - busy / wall), len(events)))

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

    for algo in routes:
        Slice.serve(routes, algo, tokens)

    for algo, label in (("hopper", "serving, hand kernels"), ("torch", "serving, library route")):
        _profile(lambda: Slice.serve(routes, algo, tokens)[1], label)

    del routes
    torch.cuda.empty_cache()

    routes, tokens, labels = Slice.buildTraining()
    for algo in routes:
        Slice.train(routes, algo, tokens, labels)

    for algo, label in (("hopper", "training, hand kernels"), ("torch", "training, library route")):
        _profile(lambda: Slice.train(routes, algo, tokens, labels), label)


if __name__ == "__main__":
    main()
