"""The card's measured roofs, the port of ``tools/roofline_probe.py``.

Run from the root of a checkout, on the card:

    python3 -m puzzlelib_tpu_torch.tools.roofline_probe

Times, by CUDA events behind a device sleep (``tools/timing.deviceMs``):

- probe kernel P3 (``ops/hopper/streamcopy``, ``x + 1``) on 64 Mi bf16
  values as (131072, 512): the kernel alone, its GB/s over the bytes read
  and written, beside ``torch.add(x, 1)``.  The JAX file counts four times
  the bytes because its XLA ``x + i`` pass rides along with the Pallas copy
  (``roofline_probe.py:84-88``); here nothing rides along;
- the NCHW -> NHWC transpose of (32, 256, 56, 56) bf16;
- bf16 GEMMs at 4096^3 and 8192^3 through cuBLAS (``torch.matmul``) and K1,
  and int8 GEMMs through ``torch._int_mm`` and K1-int8 (``matmulNT`` on B
  laid out once as B^T, as the int8 engine holds its tables);
- cuDNN 3x3 convs (``F.conv2d`` on channels-last bf16, pad 1) at ResNet-50's
  body shapes r50-56 (32, 256, 56, 56) and r50-28 (32, 512, 28, 28), which
  are VGG-16's conv3_x and conv4_x at batch 32.

Each line gives the rate and its share of the H100 SXM's data-sheet peak
(``tools/timing.py``: 3.35 TB/s, 989 TFLOP/s bf16, 1979 TOP/s int8), after
the card's name and power limit.  The JAX file's ``max`` consumer and
``timeChain`` answer XLA's strength reductions and are not ported: each call
here is one launch that writes its whole result.

``--check`` runs P3's plain version on the CPU at a small size against
``torch.add`` instead, exactly, and times nothing.  Without it the probe
needs a card and raises ``DeviceError`` where there is none.
"""

import argparse

import torch
import torch.nn.functional as F

from puzzlelib_tpu_torch.tools.timing import (
    BF16_FLOP_PER_S, HBM_BYTES_PER_S, INT8_OP_PER_S, cardName, deviceMs
)


STREAM_SHAPE = (131072, 512)
TRANSPOSE_SHAPE = (32, 256, 56, 56)
GEMM_SIZES = (4096, 8192)
CONV_SHAPES = [("r50-56", (32, 256, 56, 56), 256), ("r50-28", (32, 512, 28, 28), 512)]


def _bandwidth(label, ms, nbytes):
    rate = nbytes / ms / 1e6
    print("%-28s %9.4f ms  %8.1f GB/s (%5.1f%% of 3.35 TB/s; r+w %d bytes)" %
          (label, ms, rate, rate / HBM_BYTES_PER_S * 1e11, nbytes))
    return rate


def _compute(label, ms, ops, peak, unit="TF/s"):
    rate = ops / ms / 1e9
    print("%-28s %9.4f ms  %8.2f %s (%5.1f%% of %d)" % (label, ms, rate, unit, rate / peak * 1e14, peak / 1e12))
    return rate


def check():
    """P3's plain version against ``torch.add`` on the CPU, exactly."""
    from puzzlelib_tpu_torch.ops.hopper import streamcopy

    x = torch.randn((64, 512), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    got = streamcopy.addOne(x)
    if not torch.equal(got, torch.add(x, 1)):
        raise AssertionError("addOne differs from torch.add(x, 1)")

    print("P3 addOne on the CPU (64, 512) bf16: equal to torch.add(x, 1)")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true", help="the CPU check, no timing")
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)

    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.backend.device import getDevice

    if args.check:
        Config.device = "cpu"
        check()
        return {}

    device = getDevice()
    if device.type != "cuda":
        raise SystemExit("the roofline probe measures the card; --check runs its CPU check")

    from puzzlelib_tpu_torch.ops.hopper import matmul, streamcopy

    print(cardName())
    gen = torch.Generator(device=device).manual_seed(0)
    iters = args.iters
    rates = {}

    # -- streaming bandwidth -------------------------------------------------
    x = torch.randn(STREAM_SHAPE, generator=gen, device=device).to(torch.bfloat16)
    nbytes = 2 * x.numel() * x.element_size()

    if not torch.equal(streamcopy.addOne(x), torch.add(x, 1)):
        raise AssertionError("P3 differs from torch.add(x, 1)")

    rates["P3"] = _bandwidth("P3 addOne (kernel alone)", deviceMs(lambda: streamcopy.addOne(x), iters), nbytes)
    rates["torch.add"] = _bandwidth("torch.add(x, 1)", deviceMs(lambda: torch.add(x, 1), iters), nbytes)

    xt = x.reshape(-1)[:TRANSPOSE_SHAPE[0] * TRANSPOSE_SHAPE[1] * TRANSPOSE_SHAPE[2] * TRANSPOSE_SHAPE[3]]
    xt = xt.reshape(TRANSPOSE_SHAPE)
    rates["transpose"] = _bandwidth("nchw->nhwc %s" % (TRANSPOSE_SHAPE, ),
                                    deviceMs(lambda: xt.permute(0, 2, 3, 1).contiguous(), iters),
                                    2 * xt.numel() * xt.element_size())
    del x, xt

    # -- GEMM rates ----------------------------------------------------------
    for size in GEMM_SIZES:
        ops = 2.0 * size ** 3
        a = (torch.randn((size, size), generator=gen, device=device) * 0.1).to(torch.bfloat16)
        b = (torch.randn((size, size), generator=gen, device=device) * 0.1).to(torch.bfloat16)
        rates["cublas-%d" % size] = _compute("bf16 %d^3 cuBLAS" % size, deviceMs(lambda: torch.matmul(a, b), iters),
                                             ops, BF16_FLOP_PER_S)
        rates["K1-%d" % size] = _compute("bf16 %d^3 K1" % size, deviceMs(lambda: matmul.matmul(a, b), iters),
                                         ops, BF16_FLOP_PER_S)

        ai = torch.randint(-127, 128, (size, size), generator=gen, device=device, dtype=torch.int8)
        bi = torch.randint(-127, 128, (size, size), generator=gen, device=device, dtype=torch.int8)
        rates["int_mm-%d" % size] = _compute("int8 %d^3 torch._int_mm" % size,
                                             deviceMs(lambda: torch._int_mm(ai, bi), iters), ops, INT8_OP_PER_S,
                                             "TOP/s")
        bti = bi.t().contiguous()   # the K-major table K1-int8 on wgmma reads, laid out once
        rates["K1-int8-%d" % size] = _compute("int8 %d^3 K1-int8" % size,
                                              deviceMs(lambda: matmul.matmulNT(ai, bti), iters), ops, INT8_OP_PER_S,
                                              "TOP/s")
        del a, b, ai, bi, bti

    # -- cuDNN direct 3x3 convs (NHWC) ---------------------------------------
    for name, (n, c, h, w), co in CONV_SHAPES:
        xl = (torch.randn((n, c, h, w), generator=gen, device=device) * 0.1).to(torch.bfloat16)
        wt = (torch.randn((co, c, 3, 3), generator=gen, device=device) * 0.1).to(torch.bfloat16)
        xl, wt = xl.contiguous(memory_format=torch.channels_last), wt.contiguous(memory_format=torch.channels_last)

        ops = 2.0 * n * co * h * w * c * 9
        rates["conv-" + name] = _compute("conv %s cuDNN NHWC" % name,
                                         deviceMs(lambda: F.conv2d(xl, wt, padding=1), iters), ops, BF16_FLOP_PER_S)

    return rates


if __name__ == "__main__":
    main()
