"""Per-layer train-step profile: where the milliseconds go (counterpart of
``puzzlelib_tpu/benchmarks/layerprofile.py``).

Walks a net's leaf modules with the shapes a forward gives them and times
each leaf's forward, forward + backward-data and forward + backward-data +
backward-params on its recorded input, then prints a table of the three
directions' times, the operations, the rate, the share of the measured step
and the route the leaf took: the hand kernels that it launched (K1, K2,
K2-bwd, K3, K4, K5a, K5b, read off their launch counters around one
untimed call of the three) or "library" where it launched none, so that a
profile under ``Config.*Algo = "auto"`` shows what the race chose.  Leaves
are deduplicated by (module type, input shape, output shape, dtype), as in
the reference, and by their weights' shapes, which the reference leaves
out: a 1x1 and a 3x3 conv of one output shape (ResNet-50's
res2a_branch2a and 2b) would share one row's times.

Times on the card are the device's, by CUDA events behind a device sleep
(``tools/timing.deviceMs``), where the reference chains jitted programs; on
the CPU they are the host's (``hostMs``).  Each leaf is timed alone, so the
rows bound each layer from above and do not add up to the step.  Timing a
leaf runs its forward and backward again: its state moves as in training
(a batch norm's running statistics, the gradient buffers).

Run: python3 -m puzzlelib_tpu_torch.benchmarks.netspeed --net vgg16 --dtype bfloat16 --profile
"""

import numpy as np
import torch

from puzzlelib_tpu_torch.tools.timing import BF16_FLOP_PER_S, timeMs


def _leafModules(mod, prefix=""):
    """(path, module) leaves in execution order (containers recursed)."""
    from puzzlelib_tpu_torch.containers.container import Container
    from puzzlelib_tpu_torch.containers.parallel import Parallel
    from puzzlelib_tpu_torch.containers.sequential import Sequential

    name = mod.name or type(mod).__name__
    path = "%s/%s" % (prefix, name) if prefix else name

    if isinstance(mod, (Sequential, Parallel)):
        children = mod.graph
    elif isinstance(mod, Container):
        children = mod.modules.values()
    else:
        return [(path, mod)]

    return [leaf for child in children for leaf in _leafModules(child, path)]


def _flopsOf(mod, inshape, outshape):
    """Forward-pass product operations for the types where they are
    well-defined, as the reference counts them."""
    kind = type(mod).__name__

    if kind.startswith("Conv") or kind.startswith("Deconv"):
        spatial = int(np.prod(outshape[2:] if kind.startswith("Conv") else inshape[2:]))
        # W is (co, cpg, *k) for conv, (ci, opg, *k) for deconv
        return 2.0 * inshape[0] * spatial * int(np.prod(mod.W.shape))

    if kind == "Linear":
        return 2.0 * inshape[0] * int(np.prod(mod.W.shape))

    if kind == "GroupLinear" and mod.W is not None:
        batch = inshape[0] if mod.groupDim != 0 else inshape[1]
        return 2.0 * batch * mod.groups * mod.W.shape[-2] * mod.W.shape[-1]

    return None


def _counters():
    from puzzlelib_tpu_torch.ops.hopper import flash, matmul, winograd

    return {"K1": lambda: matmul.launches,
            "K2": lambda: winograd.launches - winograd.dataGradLaunches,
            "K2-bwd": lambda: winograd.dataGradLaunches,
            "K3": lambda: winograd.filterGradLaunches,
            "K4": lambda: flash.launches,
            "K5a": lambda: flash.launchesDq,
            "K5b": lambda: flash.launchesDkv}


def routeOf(fn):
    """The hand kernels that one call of ``fn`` launched, by name, or
    "library" where it launched none."""
    counters = _counters()
    before = {name: read() for name, read in counters.items()}
    fn()
    launched = [name for name, read in counters.items() if read() > before[name]]
    return " ".join(launched) if launched else "library"


def _profileLeaf(mod, x, grad, iters, device):
    """(fwd, fwd + bwdData, fwd + bwdData + bwdParams) ms and the route."""
    hasParams = any(var.grad is not None for var in mod.vars.values())

    def fwd():
        mod(x)

    def fwdBwd():
        mod(x)
        mod.updateGrad(grad)

    def fwdBwdParams():
        fwdBwd()
        mod.accGradParams(grad)

    route = routeOf(fwdBwdParams if hasParams else fwdBwd)
    tF = timeMs(fwd, iters, device)
    tFB = timeMs(fwdBwd, iters, device)
    tFBP = timeMs(fwdBwdParams, iters, device) if hasParams else tFB
    return (tF, max(tFB, tF), max(tFBP, tFB)), route


def profileNet(net, data, stepSecs=None, iters=5, out=print):
    """Print the per-layer table for one train step of ``net`` on ``data``
    (a tensor on the net's device); returns its rows (path, module, input
    shape, output shape, ((fwd, fwdBwd, fwdBwdParams) ms, route) or None
    for a leaf whose input or output is a list, or the exception its timing
    raised).  ``stepSecs``: the measured whole step, for the share column
    and the sum line."""
    device = data.device
    net(data)    # the recording forward: the leaves keep their inData / data
    leaves = _leafModules(net)

    rows, cache = [], {}
    for path, mod in leaves:
        inData, outData = mod.inData, mod.data

        if not isinstance(inData, torch.Tensor) or not isinstance(outData, torch.Tensor):
            rows.append((path, mod, None, None, None))
            continue

        sig = (type(mod).__name__, tuple(inData.shape), tuple(outData.shape), str(inData.dtype),
               tuple(tuple(var.data.shape) for var in mod.vars.values()))
        if sig not in cache:
            x = inData.clone()
            gen = torch.Generator(device=device).manual_seed(len(cache))
            grad = (torch.randn(outData.shape, generator=gen, device=device) * 0.1).to(outData.dtype)
            try:
                cache[sig] = _profileLeaf(mod, x, grad, iters, device)
            except Exception as exc:   # a row of the table, not the run: it prints the failure
                cache[sig] = exc
            mod.reset()

        rows.append((path, mod, sig[1], sig[2], cache[sig]))

    net.reset()
    _report(rows, data.dtype == torch.bfloat16, stepSecs, device, out)
    return rows


def _report(rows, isBf16, stepSecs, device, out):
    out("%-44s %18s %10s %10s %10s %9s %6s %6s  %s" %
        ("layer", "out shape", "fwd ms", "bwdD ms", "bwdP ms", "TF/s", "%peak", "%step", "route"))

    totals = [0.0, 0.0, 0.0]
    for path, mod, inshape, outshape, result in rows:
        shapeStr = "x".join(map(str, outshape)) if outshape else "-"

        if result is None:
            out("%-44s %18s %10s" % (path[-44:], shapeStr[-18:], "(skip)"))
            continue
        if isinstance(result, Exception):
            out("%-44s %18s  FAILED: %s" % (path[-44:], shapeStr[-18:], str(result)[:80]))
            continue

        (tF, tFB, tFBP), route = result
        times = (tF, tFB - tF, tFBP - tFB)
        totals = [t + d for t, d in zip(totals, times)]
        layerMs = sum(times)

        flops = _flopsOf(mod, inshape, outshape)
        tfsStr, peakStr = "%9s" % "-", "%6s" % "-"
        if flops and layerMs > 0:
            # forward, bwd-data and bwd-params each take about ``flops``
            dirs = 1 + (times[1] > 0) + (times[2] > 0)
            tfs = flops * dirs / layerMs / 1e9
            tfsStr = "%9.2f" % tfs
            if isBf16 and device.type == "cuda":
                peakStr = "%6.1f" % (tfs * 1e14 / BF16_FLOP_PER_S)

        stepStr = "%6.1f" % (layerMs / (stepSecs * 1e3) * 100) if stepSecs else "%6s" % "-"
        out("%-44s %18s %10.4f %10.4f %10.4f %s %s %s  %s" %
            (path[-44:], shapeStr[-18:], times[0], times[1], times[2], tfsStr, peakStr, stepStr, route))

    out("%-44s %18s %10.4f %10.4f %10.4f" % ("TOTAL (sum of layers)", "", *totals))
    if stepSecs:
        out("measured step: %.4f ms; sum of the layers timed alone: %.4f ms (%.0f%%)%s" %
            (stepSecs * 1e3, sum(totals), sum(totals) / (stepSecs * 1e3) * 100,
             "" if device.type == "cuda" else " (cpu)"))
