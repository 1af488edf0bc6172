"""The strided phase-slab copy on the card, the port of
``tools/strided_dma_probe.py``.

Run from the root of a checkout, on the card:

    python3 -m puzzlelib_tpu_torch.tools.strided_dma_probe

Probe kernel P2 (``ops/hopper/phasesplit``) copies the four stride-2 phase
slabs of batch 0 of an NHWC image, viewed as x6 (N, H/2, 2, W/2, 2, C), into
(tiles, 4, rows, W/2, C).  At each shape the probe checks the copy exactly
against the slabs cut from x6 by numpy (``strided_dma_probe.py:94-101``),
then times the kernel and the permuted ``.contiguous()`` copy (its plain
version and the library's way) by CUDA events behind a device sleep, with
their GB/s over the bytes read and written and the share of the H100's 3.35
TB/s, after the card's name and power limit.  Shapes: the file's own (1,
64, 64, 256) bf16 at 4 rows a tile, and (1, 224, 224, 64), VGG-16's largest
activation at batch 1.

``--check`` runs the same exactness check on the CPU through the plain
version at a small shape, and times nothing.  Without it the probe needs a
card and raises ``DeviceError`` where there is none.
"""

import argparse

import numpy as np
import torch

from puzzlelib_tpu_torch.tools.timing import HBM_BYTES_PER_S, cardName, deviceMs


ROWS = 4
SHAPES = [(1, 64, 64, 256), (1, 224, 224, 64)]
CHECK_SHAPE = (1, 16, 16, 128)


def operands(shape, device, rows=ROWS):
    """(x6, geometry) for an NHWC image of ``shape``, seeded, bf16: x6 its
    (N, H/2, 2, W/2, 2, C) view and geometry ``phaseSplit``'s keywords."""
    n, h, w, c = shape
    x = torch.from_numpy(np.random.RandomState(0).randn(*shape).astype(np.float32)).to(device).to(torch.bfloat16)
    x6 = x.reshape(n, h // 2, 2, w // 2, 2, c)
    return x6, dict(rows=rows, tw=w // 2, c=c, nTiles=(h // 2) // rows)


def exact(out, x6, rows, tw, c, nTiles):
    """The probe's check: each tile's four slabs against numpy's cut of x6."""
    want = x6.float().cpu().numpy().transpose(2, 4, 0, 1, 3, 5).reshape(4, -1, tw, c)   # ap bp, i, j, c (batch 0)
    got = out.float().cpu().numpy()

    for t in range(nTiles):
        for p in range(4):
            np.testing.assert_array_equal(got[t, p], want[p, t * rows:(t + 1) * rows])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true", help="the CPU check, no timing")
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)

    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.backend.device import getDevice
    from puzzlelib_tpu_torch.ops.hopper import phasesplit

    if args.check:
        Config.device = "cpu"
        x6, geometry = operands(CHECK_SHAPE, "cpu")
        exact(phasesplit.phaseSplit(x6, **geometry), x6, **geometry)
        print("P2 phaseSplit on the CPU %s bf16, %d rows a tile: exact" % (CHECK_SHAPE, ROWS))
        return {}

    device = getDevice()
    if device.type != "cuda":
        raise SystemExit("the strided-copy probe measures the card; --check runs its CPU check")

    print(cardName())
    rates = {}

    for shape in SHAPES:
        x6, geometry = operands(shape, device)
        out = phasesplit.phaseSplit(x6, **geometry)
        exact(out, x6, **geometry)

        nbytes = 2 * out.numel() * out.element_size()
        ms = deviceMs(lambda: phasesplit.phaseSplit(x6, **geometry), args.iters)
        plainMs = deviceMs(lambda: phasesplit.plain(x6, **geometry), args.iters)

        rates[shape] = nbytes / ms / 1e6
        print("P2 %s bf16, %d rows a tile: exact; kernel %.4f ms, %.1f GB/s (%.1f%% of 3.35 TB/s); permuted copy "
              "%.4f ms, %.1f GB/s (r+w %d bytes)" %
              (shape, ROWS, ms, rates[shape], rates[shape] / HBM_BYTES_PER_S * 1e11, plainMs, nbytes / plainMs / 1e6,
               nbytes))

    return rates


if __name__ == "__main__":
    main()
