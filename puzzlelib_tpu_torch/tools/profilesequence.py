"""Where the device time of the sequence slice goes, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 -m puzzlelib_tpu_torch.tools.profilesequence

Builds the runs of ``tools/sequenceslice.py`` and profiles, each once to
warm up and once under ``torch.profiler`` (``profileresnet._run``: the
wall time, the device's busy time, the idle share, the device time by
kernel name and its split into the hand kernels, PyTorch's elementwise and
reduction kernels, and the rest):

- the three IMDB nets (LSTM, BiLSTM, 1-d CNN) training 4 steps of 32 on the
  hand route, the fused route and the library route;
- Wave2Letter in bf16, serving 4 requests of 8 and training 4 steps of 8
  with CTC.

Then it times, by CUDA events behind a device sleep and by the host clock,
one ``ops.ctc.ctcLoss`` at the slice's shape (T 800, batch 8, 29 symbols)
beside ``torch.nn.functional.ctc_loss`` on the same scores (the library's
CTC, which the port does not call: it gives inf where a sample's labels
cannot fit); and the 1-d library bwd-filter with cuDNN's deterministic
algorithms, as the port runs it, beside cuDNN's heuristic choice, at the
IMDB CNN's conv and at Wave2Letter's first two convs.  ``chip_smoke.py``
[imdb-rnn] and [w2l] give the routes' throughput outside the profiler.
"""

import time

import numpy as np
import torch

from puzzlelib_tpu_torch.tools import sequenceslice as Seq
from puzzlelib_tpu_torch.tools.profileresnet import _run
from puzzlelib_tpu_torch.tools.timing import cardName, deviceMs


ROUTES = (("hopper", "hand kernels"), ("fused", "fused"), ("torch", "library route"))


def _hostMs(fn, iters=3):
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / iters * 1e3


def profileImdb():
    for kind in Seq.NETS:
        run = Seq.buildRun(kind)
        rows, labels = Seq.data(kind, Seq.BATCH * Seq.STEPS)

        for algo, _ in ROUTES:
            run.train(algo, rows, labels)

        for algo, label in ROUTES:
            _run(lambda: run.train(algo, rows, labels), "IMDB %s training %d steps of %d, %s" %
                 (kind, Seq.STEPS, Seq.BATCH, label))

        del run


def profileW2L():
    frames, labels, lengths = Seq.w2lData(Seq.W2L_BATCH * Seq.W2L_STEPS)
    run = Seq.W2LRun(Seq.buildW2L())
    run.serve(frames)
    run.train(frames, labels, lengths)

    _run(lambda: run.serve(frames)[1], "Wave2Letter bf16 serving %d requests of %d" % (Seq.W2L_REQUESTS, run.batch))
    _run(lambda: run.train(frames, labels, lengths), "Wave2Letter bf16 training %d steps of %d" %
         (Seq.W2L_STEPS, run.batch))

    out, _ = run.serve(frames[:run.batch])
    return out, labels, lengths, run


def timeCtc(out, labels, lengths, batch):
    from puzzlelib_tpu_torch.ops import ctc

    scores = torch.from_numpy(out).cuda().permute(2, 0, 1).contiguous()
    lens = lengths[:batch]
    flat = labels[:int(lens.sum())]
    datalen = np.full(batch, scores.shape[0], dtype=np.int32)

    port = lambda: ctc.ctcLoss(scores, datalen, flat, lens, Seq.W2L_BLANK)
    library = lambda: torch.nn.functional.ctc_loss(
        torch.log_softmax(scores, 2), torch.from_numpy(flat).cuda(), torch.from_numpy(datalen).cuda(),
        torch.from_numpy(lens).cuda(), reduction="sum", blank=Seq.W2L_BLANK
    )
    port()

    print("[profile] CTC at (T, B, V) = %s, %d to %d labels: ops.ctc.ctcLoss %.3f ms on the device, %.3f ms by the "
          "host clock; torch.nn.functional.ctc_loss %.3f ms on the device, %.3f ms by the host clock" %
          (tuple(scores.shape), lens.min(), lens.max(), deviceMs(port, 3), _hostMs(port),
           deviceMs(library, 10), _hostMs(library, 10)))


def timeFilterGrad(run):
    """The port's 1-d library bwd-filter (deterministic) beside cuDNN's
    heuristic choice, at the IMDB CNN's conv and Wave2Letter's first two
    convs, on the shapes and types the slice gives them."""
    from puzzlelib_tpu_torch.ops import conv as convOps

    gen = torch.Generator(device="cuda").manual_seed(4)
    graph = run.net.graph
    cases = [("IMDB CNN conv (f32)", (Seq.BATCH, 50, 250), (50, 50, 3), 1, 1, torch.float32)]
    for block, conv in enumerate((graph[1], graph[6])):
        insize = Seq.W2L_FRAMES + 2 * 5 if block == 0 else Seq.W2L_FRAMES // 2 + 2 * 5
        cases.append(("Wave2Letter block %d conv (bf16)" % block, (run.batch, conv.W.shape[1], insize),
                      tuple(conv.W.shape), conv.stride[0], conv.dilation[0], torch.bfloat16))

    for name, xshape, wshape, stride, dilation, dtype in cases:
        x = torch.randn(xshape, device="cuda", generator=gen).to(dtype)
        outsize = (xshape[2] - dilation * (wshape[2] - 1) - 1) // stride + 1
        grad = torch.randn((xshape[0], wshape[0], outsize), device="cuda", generator=gen).to(dtype)
        args = ((stride, ), (0, ), (dilation, ), 1)

        deterministic = lambda: convOps._filterGrad(x, grad, wshape, *args)
        heuristic = lambda: torch.nn.grad.conv1d_weight(x, wshape, grad, stride=stride, dilation=dilation)
        print("[profile] 1-d bwd-filter, %s, x %s, W %s: deterministic (the port's) %.4f ms, cuDNN's heuristic "
              "choice %.4f ms" % (name, xshape, wshape, deviceMs(deterministic, 10), deviceMs(heuristic, 10)))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile needs an NVIDIA GPU")

    from puzzlelib_tpu_torch import config as Config

    print(cardName())
    Config.device = "cuda"
    profileImdb()
    out, labels, lengths, run = profileW2L()
    timeCtc(out, labels, lengths, run.batch)
    timeFilterGrad(run)


if __name__ == "__main__":
    main()
