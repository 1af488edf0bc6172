#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``puzzlelib_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its lines and ending the run with a non-zero exit when
it fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compiles the hand-written kernels from ``puzzlelib_tpu_torch/csrc``
   with ``nvcc`` into ``build/kernels`` and prints the seconds it took and
   the compiler's register / spill report;
3. K1 (GEMM) against its plain PyTorch version at the VGG-16 fc shapes
   (M = 32) in bf16 and f32, and a ragged 100 x 200 x 60;
4. K2 (Winograd conv) against its plain version and against an f32
   ``F.conv2d`` with TF32 off, at each distinct Winograd-eligible VGG-16 conv
   at batch 32;
5. the slice: VGG-16 at full width in bf16, random He weights from
   ``np.random.seed(0)``, 128 seeded images through
   ``Calculator(net, batchsize=32).calcFromHost``.  The launch counters of
   both kernels are reset just before and read just after that run; the
   output is checked for shape, finiteness and softmax rows, and fc8 of the
   first batch against the same f32 weights run on the library route.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or
without the package beside it, the script exits non-zero and prints no
result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np


BATCH = 32
REQUESTS = 4

# (name, x shape NCHW, output channels): each distinct 3x3 conv of VGG-16
# that the Winograd kernel takes, at batch 32, with how often one forward
# pass runs it
WINOGRAD_SHAPES = [
    ("conv2_2", (BATCH, 128, 112, 112), 128, 1),
    ("conv3_1", (BATCH, 128, 56, 56), 256, 1),
    ("conv3_2", (BATCH, 256, 56, 56), 256, 2),
    ("conv4_1", (BATCH, 256, 28, 28), 512, 1),
    ("conv4_2", (BATCH, 512, 28, 28), 512, 2),
    ("conv5_1", (BATCH, 512, 14, 14), 512, 3),
]

# (name, M, K, N): the fc layers at batch 32, and a ragged shape whose K and
# N are no multiples of 8 (the kernel's scalar-load path)
GEMM_SHAPES = [
    ("fc6", BATCH, 25088, 4096),
    ("fc7", BATCH, 4096, 4096),
    ("fc8", BATCH, 4096, 1000),
    ("ragged", 100, 200, 60),
]

# max |kernel - plain| / max |plain|.  bf16: both round one f32 sum to bf16
# (8 mantissa bits, half an ulp is 2^-9 = 2e-3 of the value) and differ only
# in summation order, so they disagree by at most about one bf16 ulp (4e-3).
# f32: only the order of K f32 additions differs, ~sqrt(K) * 6e-8 < 1e-5.
GEMM_BOUND = {"bf16": 1e-2, "f32": 1e-4}

# Winograd: kernel vs plain share every rounding point (V and U rounded to
# bf16, f32 sums, bf16 output), so they differ by summation order and the
# final rounding.  Against the f32 direct conv the bf16 inputs of the 16
# GEMMs cost about one more mantissa bit than a direct bf16 conv; the
# reference measured ~6e-3 against its f32 oracle.
WINOGRAD_BOUND_PLAIN = 1e-2
WINOGRAD_BOUND_F32 = 2e-2

# relative L2 error of fc8 against the f32 run: the bf16 tier of the
# reference's dtype table (puzzlelib_tpu/tensor.py dtypesSupported)
SLICE_BOUND = 5e-2


def fail(message):
    raise SystemExit("chip_smoke FAILED: %s" % message)


def cudaMs(torch, fn, iters):
    """Mean milliseconds of ``fn`` on the card, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()

    return start.elapsed_time(end) / iters


def relErr(torch, got, ref):
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max()).item()


def phaseDevice(torch):
    query = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    if query.returncode != 0 or not query.stdout.strip():
        fail("nvidia-smi gave no card name and power limit: %s" % query.stderr.strip())

    card = query.stdout.strip().splitlines()[0].strip()
    print(card)
    print("[device] %s | torch %s, CUDA %s, %d card(s)" %
          (torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda, torch.cuda.device_count()))
    return card


def phaseBuild(build):
    start = time.perf_counter()
    build.buildAll()
    secs = time.perf_counter() - start

    print("[build] kernels built in %.2f s into %s" % (secs, build.BUILD_DIR))
    for name in build.KERNELS:
        for line in build.compilerReport(name):
            print("[build] %s: %s" % (name, line))


def phaseGemm(torch, matmul):
    gen = torch.Generator(device="cuda").manual_seed(1)
    main = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}

    for dtName, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for name, m, k, n in GEMM_SHAPES:
            a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
            b = (torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5).to(dtype)

            out, ref = matmul.matmul(a, b), matmul.plain(a, b)
            torch.cuda.synchronize()

            err = relErr(torch, out, ref)
            ms = cudaMs(torch, lambda: matmul.matmul(a, b), 10)
            plainMs = cudaMs(torch, lambda: matmul.plain(a, b), 10)

            print("[K1] %-6s %s M=%d K=%d N=%d: rel err %.3e (bound %.0e), kernel %.4f ms, plain %.4f ms" %
                  (name, dtName, m, k, n, err, GEMM_BOUND[dtName], ms, plainMs))

            if not err <= GEMM_BOUND[dtName]:
                fail("K1 %s %s disagrees with its plain version: %.3e" % (name, dtName, err))

            if dtName == "bf16" and name != "ragged":
                main["max_abs_err"] = max(main["max_abs_err"], (out.float() - ref.float()).abs().max().item())
                main["ms"] += ms
                main["plain_ms"] += plainMs

    return main


def phaseWinograd(torch, winograd):
    import torch.nn.functional as F

    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on although Config.matmulPrecision is 'highest'")

    gen = torch.Generator(device="cuda").manual_seed(2)
    main = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}

    for name, xshape, co, count in WINOGRAD_SHAPES:
        c = xshape[1]
        x = torch.randn(xshape, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn((co, c, 3, 3), generator=gen, device="cuda") * (2.0 / (9 * c)) ** 0.5).to(torch.bfloat16)

        out = winograd.conv2d(x, w, (1, 1))
        plain = winograd.plain(x, w, (1, 1))
        direct = F.conv2d(x.float(), w.float(), padding=1)
        torch.cuda.synchronize()

        errPlain, errF32 = relErr(torch, out, plain), relErr(torch, out, direct)
        absPlain = (out.float() - plain.float()).abs().max().item()
        del plain, direct

        ms = cudaMs(torch, lambda: winograd.conv2d(x, w, (1, 1)), 10)
        plainMs = cudaMs(torch, lambda: winograd.plain(x, w, (1, 1)), 3)
        libMs = cudaMs(torch, lambda: F.conv2d(x, w, padding=1), 10)

        print("[K2] %-7s x=%s co=%d: rel err %.3e vs plain (bound %.0e), %.3e vs f32 conv (bound %.0e); "
              "kernel %.4f ms, plain %.4f ms, library bf16 conv %.4f ms" %
              (name, xshape, co, errPlain, WINOGRAD_BOUND_PLAIN, errF32, WINOGRAD_BOUND_F32,
               ms, plainMs, libMs))

        if not errPlain <= WINOGRAD_BOUND_PLAIN:
            fail("K2 %s disagrees with its plain version: %.3e" % (name, errPlain))

        if not errF32 <= WINOGRAD_BOUND_F32:
            fail("K2 %s disagrees with the f32 conv: %.3e" % (name, errF32))

        main["max_abs_err"] = max(main["max_abs_err"], absPlain)
        main["ms"] += ms * count
        main["plain_ms"] += plainMs * count

    torch.cuda.empty_cache()
    return main


def phaseSlice(torch, card):
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.backend.device import synchronize
    from puzzlelib_tpu_torch.handlers import Calculator
    from puzzlelib_tpu_torch.models.nets import loadVGG
    from puzzlelib_tpu_torch.ops.hopper import matmul, winograd

    Config.device = "cuda"
    Config.globalEvalMode = True   # no gradient buffers for a serving net

    np.random.seed(0)
    net = loadVGG(None, "16", initscheme="he")
    images = np.random.RandomState(1).randn(BATCH * REQUESTS, 3, 224, 224).astype(np.float32)
    first = torch.from_numpy(images[:BATCH]).cuda()

    # the f32 reference: the same weights on the library route (TF32 off)
    Config.gemmAlgo = Config.convAlgo = "torch"
    net.evalMode()
    net(first)
    refFc8 = net["fc8"].data.float().clone()
    net.reset()
    Config.gemmAlgo = Config.convAlgo = "hopper"

    net.calcMode(torch.bfloat16)

    def serve():
        """One timed ``calcFromHost`` of all the images: (output, seconds)."""
        synchronize()
        start = time.perf_counter()
        result = Calculator(net, batchsize=BATCH).calcFromHost(images)
        synchronize()
        return result, time.perf_counter() - start

    # warm-up of both routes: library conv plans, allocator blocks of these sizes
    for algo in ("torch", "hopper"):
        Config.gemmAlgo = Config.convAlgo = algo
        serve()

    matmul.launches = winograd.launches = 0
    out, secs = serve()
    launches = {"matmul": matmul.launches, "winograd": winograd.launches}

    print("[slice] VGG-16 bf16, %d images in %d requests of %d: %.4f s, %.1f images/s on %s" %
          (len(images), REQUESTS, BATCH, secs, len(images) / secs, card))
    print("[slice] launches in that run: winograd %d, matmul %d" % (launches["winograd"], launches["matmul"]))

    if launches != {"matmul": 3 * REQUESTS, "winograd": 10 * REQUESTS}:
        fail("expected 40 Winograd and 12 GEMM launches, got %s" % launches)

    if out.shape != (len(images), 1000) or not np.isfinite(out).all():
        fail("output of shape %s, finite: %s" % (out.shape, np.isfinite(out).all()))

    rowSums = np.abs(out.sum(axis=1) - 1.0).max()
    if not rowSums <= 2e-2:
        fail("softmax rows do not sum to 1 (max deviation %.3e)" % rowSums)

    # steady state, and the same bf16 runs on the library route for the cost
    # of the kernels end to end, in turns
    runs = {"hopper": [], "torch": []}
    for _ in range(5):
        for algo in ("hopper", "torch"):
            Config.gemmAlgo = Config.convAlgo = algo
            runs[algo].append(serve()[1])
    Config.gemmAlgo = Config.convAlgo = "hopper"

    for algo, label in (("hopper", "hand kernels"), ("torch", "library route (cuBLAS / cuDNN)")):
        print("[slice] %s, 5 runs in turns: %s s, median %.1f images/s" %
              (label, " ".join("%.4f" % t for t in runs[algo]), len(images) / float(np.median(runs[algo]))))

    net(torch.from_numpy(images[:BATCH]).cuda().to(torch.bfloat16))
    fc8 = net["fc8"].data.float()
    rel = ((fc8 - refFc8).norm() / refFc8.norm()).item()
    net.reset()

    print("[slice] fc8 of the first request vs the f32 library run: relative L2 %.3e (bound %.0e); "
          "softmax rows within %.2e of 1" % (rel, SLICE_BOUND, rowSums))

    if not rel <= SLICE_BOUND:
        fail("fc8 relative L2 error %.3e against the f32 run" % rel)

    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke test needs an NVIDIA GPU")

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    from puzzlelib_tpu_torch.backend.device import ensureInit
    from puzzlelib_tpu_torch.ops.hopper import build, matmul, winograd

    ensureInit()

    card = phaseDevice(torch)
    phaseBuild(build)
    gemm = phaseGemm(torch, matmul)
    wino = phaseWinograd(torch, winograd)
    launches = phaseSlice(torch, card)

    kernels = [
        dict(name="K1 tiled GEMM", route="cuda", source="puzzlelib_tpu_torch/csrc/matmul.cu",
             replaces="puzzlelib_tpu/ops/pallas/matmul.py:18", launches=launches["matmul"], **gemm),
        dict(name="K2 Winograd F(2x2,3x3) forward", route="cuda", source="puzzlelib_tpu_torch/csrc/winograd.cu",
             replaces="puzzlelib_tpu/ops/pallas/winograd.py:79", launches=launches["winograd"], **wino),
    ]
    print("[kernels] ms and plain_ms: the time one batch of 32 spends in the kernel (K1: fc6+fc7+fc8 in bf16; "
          "K2: the 10 Winograd convs, wrapper included) and in its plain version; max_abs_err: largest "
          "|kernel - plain| at those shapes")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
