"""The pitch-row tap-dot direct conv on the card, the port of
``tools/tapdot_probe.py``.

Run from the root of a checkout, on the card:

    python3 -m puzzlelib_tpu_torch.tools.tapdot_probe

Probe kernel P1 (``ops/hopper/tapdot``) runs a stride-1 3x3 conv as 9
shifted-row products in pitch layout.  At each shape, bf16 operands from a
seed at pad 1: the relative error of ``tapdot.conv2d`` against the f32 conv
(max |error| / max |f32|, the file's 5e-2 gate, ``tapdot_probe.py:244``),
then device times by CUDA events behind a device sleep: the kernel alone on
its prepared operands, the whole ``conv2d`` (layout, kernel, crop), cuDNN's
``F.conv2d`` on channels-last bf16, and K2 (``winograd.conv2d``) where it
takes the shape, each with TFLOP/s on the useful operations (2 N CO OH OW C
9, ``tapdot_probe.py:222``) and the share of the H100's 989 TFLOP/s, after
the card's name and power limit.  Shapes: the file's three (r50-56 = VGG-16
conv3_x and r50-28 = conv4_x at batch 32, vgg-112 at batch 16) and VGG-16's
conv2_2 and conv5_2 at batch 32.

``--check`` (the file's ``--interpret``) runs the plain version on the CPU at
the file's two shapes, (2, 128, 12, 10) 3x3 pad 1 and (1, 128, 9, 9) 5x5
pad 2, in f32 against a direct conv in f64 (``tapdot_probe.py:188-208``),
and times nothing.  Without it the probe needs a card and raises
``DeviceError`` where there is none.
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from puzzlelib_tpu_torch.tools.timing import BF16_FLOP_PER_S, cardName, deviceMs


# (name, x shape NCHW, output channels), 3x3 at pad 1
SHAPES = [
    ("r50-56", (32, 256, 56, 56), 256),
    ("r50-28", (32, 512, 28, 28), 512),
    ("vgg-112", (16, 128, 112, 112), 128),
    ("conv2_2", (32, 128, 112, 112), 128),
    ("conv5_2", (32, 512, 14, 14), 512),
]

# (n, c, h, w, co, k, pad): the file's --interpret shapes
CHECK_SHAPES = [(2, 128, 12, 10, 128, 3, 1), (1, 128, 9, 9, 128, 5, 2)]

GATE = 5e-2


def directConv(x, w, pad):
    """The conv of numpy x (N, C, H, W) with w (CO, C, k, k) in f64 as the
    file writes it: a sum of per-tap channel products."""
    n, _, h, wd = x.shape
    co, _, kh, kw = w.shape
    oh, ow = h + 2 * pad - kh + 1, wd + 2 * pad - kw + 1

    xn = np.pad(x.astype(np.float64), ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    ref = np.zeros((n, co, oh, ow))
    for i in range(kh):
        for j in range(kw):
            ref += np.einsum("nchw,oc->nohw", xn[:, :, i:i + oh, j:j + ow], w[:, :, i, j].astype(np.float64))

    return ref


def check():
    from puzzlelib_tpu_torch.ops.hopper import tapdot

    rng = np.random.RandomState(5)
    for n, c, h, w, co, k, p in CHECK_SHAPES:
        x = rng.randn(n, c, h, w).astype(np.float32)
        wt = (rng.randn(co, c, k, k) * 0.1).astype(np.float32)

        out = tapdot.conv2d(torch.from_numpy(x), torch.from_numpy(wt), (p, p)).numpy()
        ref = directConv(x, wt, p)

        err = np.abs(out - ref).max()
        print("P1 conv2d on the CPU, shape %s k%d: err %.2e" % ((n, c, h, w, co), k, err))
        if not err < 1e-3 * max(1.0, np.abs(ref).max()):
            raise AssertionError("tap-dot conv of %s k%d is off the f64 conv by %.2e" % ((n, c, h, w, co), k, err))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true", help="the CPU check of the file's --interpret, no timing")
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args(argv)

    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.backend.device import getDevice

    if args.check:
        Config.device = "cpu"
        check()
        return {}

    device = getDevice()
    if device.type != "cuda":
        raise SystemExit("the tap-dot probe measures the card; --check runs its CPU check")

    from puzzlelib_tpu_torch.ops.hopper import tapdot, winograd

    print(cardName())
    gen = torch.Generator(device=device).manual_seed(0)
    results = {}

    def rate(ms, flops):
        return "%8.4f ms %7.2f TF/s (%4.1f%% peak)" % (ms, flops / ms / 1e9, flops / ms / 1e9 / BF16_FLOP_PER_S * 1e14)

    for name, (n, c, h, w), co in SHAPES:
        x = (torch.randn((n, c, h, w), generator=gen, device=device) * 0.3).to(torch.bfloat16)
        wt = (torch.randn((co, c, 3, 3), generator=gen, device=device) * 0.1).to(torch.bfloat16)
        flops = 2.0 * n * co * h * w * c * 9

        ref = F.conv2d(x.float(), wt.float(), padding=1)
        got = tapdot.conv2d(x, wt, (1, 1))
        err = ((got.float() - ref).abs().max() / ref.abs().max()).item()
        del ref, got

        print("%-8s %s co %d: rel err %.2e vs the f32 conv (gate %.0e)" % (name, (n, c, h, w), co, err, GATE))
        if not err <= GATE:
            raise AssertionError("P1 %s off the f32 conv by %.2e" % (name, err))

        xp, wk, geometry, _ = tapdot.layout(x, wt, (1, 1))
        xl, wl = x.contiguous(memory_format=torch.channels_last), wt.contiguous(memory_format=torch.channels_last)

        times = {"kernel": deviceMs(lambda: tapdot.tapdot(xp, wk, **geometry), args.iters),
                 "conv2d": deviceMs(lambda: tapdot.conv2d(x, wt, (1, 1)), args.iters),
                 "cudnn": deviceMs(lambda: F.conv2d(xl, wl, padding=1), args.iters)}
        if winograd.applicable((n, c, h, w), (co, c, 3, 3), (1, 1), (1, 1), (1, 1), 1):
            times["K2"] = deviceMs(lambda: winograd.conv2d(x, wt, (1, 1)), args.iters)

        for label, text in (("kernel", "P1 kernel alone"), ("conv2d", "P1 conv2d, layout + crop"),
                            ("cudnn", "cuDNN NHWC"), ("K2", "K2 Winograd")):
            if label in times:
                print("  %-26s %s" % (text, rate(times[label], flops)))

        results[name] = dict(times, err=err)
        del x, wt, xp, wk, xl, wl

    return results


if __name__ == "__main__":
    main()
