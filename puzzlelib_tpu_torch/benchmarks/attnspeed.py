"""Attention benchmark: the flash kernels against the composed attention and
the library's fused attention (counterpart of
``puzzlelib_tpu/benchmarks/attnspeed.py``).

Run:  python3 -m puzzlelib_tpu_torch.benchmarks.attnspeed [--seqs 2048,4096] [--batch 4]
          [--heads 8] [--dim 64] [--iters 10] [--device cpu]

Times a training step's attention, the gradient of sum(out^2) with respect
to q, k and v, for each sequence length, causal off and on, bf16:

- flash: ``ops/hopper/flash.FlashAttention``, kernels K4 forward and K5a /
  K5b backward;
- composed: ``ops/attention.attention`` and its VJP ``attentionBackward``
  (the "xla" route of ``MultiHeadAttention``);
- library: ``scaled_dot_product_attention`` under autograd, the yardstick,
  which the port never calls.

Each line gives ms and TFLOP/s on the file's count, 4 b h s^2 d x 3.5
(forward and ~2.5x for the backward, ``attnspeed.py:75``), and the composed
and library times over flash's.  Times on the card are the device's, by CUDA
events behind a device sleep, after the card's name and power limit; with
``--device cpu`` they are the CPU's, and the kernels run their plain
versions.  On the card each shape's winner of flash against the composed
route is written into the "auto" table (``ops.attention._attnChoice``:
flash only below 0.97x composed, as ``measureAttnChoice`` records it), and
the table is printed at the end, as the reference does
(``attnspeed.py:84-91``); on the CPU nothing is recorded.  Without
``--device cpu`` the script needs a card and raises ``DeviceError`` where
there is none.
"""

import argparse

import torch
import torch.nn.functional as F

from puzzlelib_tpu_torch.tools.timing import cardName, timeMs


def _sumSquares(out):
    return (out.float() ** 2).sum()


def flashGrad(q, k, v, causal):
    from puzzlelib_tpu_torch.ops.hopper.flash import flashAttention

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(_sumSquares(flashAttention(*leaves, causal)), leaves)


def composedGrad(q, k, v, causal):
    from puzzlelib_tpu_torch.ops.attention import attention, attentionBackward

    out = attention(q, k, v, causal)
    return attentionBackward(q, k, v, (2 * out.float()).to(out.dtype), causal)


def libraryGrad(q, k, v, causal):
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(_sumSquares(F.scaled_dot_product_attention(*leaves, is_causal=causal)), leaves)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seqs", default="2048,4096")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--heads", type=int, default=8)
    parser.add_argument("--dim", type=int, default=64)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--device", default=None, help="cpu to run on the CPU; default the card")
    args = parser.parse_args(argv)

    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.backend.device import getDevice

    if args.device is not None:
        Config.device = args.device
    device = getDevice()

    if device.type == "cuda":
        print(cardName())

    b, h, d = args.batch, args.heads, args.dim
    gen = torch.Generator(device=device).manual_seed(1)
    results = {}

    for s in [int(x) for x in args.seqs.split(",")]:
        q, k, v = [(torch.randn((b, h, s, d), generator=gen, device=device) * 0.5).to(torch.bfloat16)
                   for _ in range(3)]
        flops = 4 * b * h * s * s * d * 3.5

        for causal in (False, True):
            times = {label: timeMs(lambda: fn(q, k, v, causal), args.iters, device)
                     for label, fn in (("flash", flashGrad), ("composed", composedGrad), ("library", libraryGrad))}
            results[(s, causal)] = times

            where = "" if device.type == "cuda" else " (cpu)"
            print("seq %5d causal=%d | flash %8.3f ms (%6.1f TF/s) | composed %8.3f ms (%6.1f TF/s) %.2fx | "
                  "scaled_dot_product_attention %8.3f ms (%6.1f TF/s) %.2fx%s" %
                  (s, causal, times["flash"], flops / times["flash"] / 1e9, times["composed"],
                   flops / times["composed"] / 1e9, times["composed"] / times["flash"], times["library"],
                   flops / times["library"] / 1e9, times["library"] / times["flash"], where))

            if device.type == "cuda":
                _record(b, h, s, d, causal, times["flash"], times["composed"])

    if device.type == "cuda":
        from puzzlelib_tpu_torch.ops import attention as attnops
        print("dispatch table:", sorted(attnops._attnChoice.items()))

    return results


def _record(b, h, s, d, causal, flashMs, composedMs):
    """Write the winner at this signature into the "auto" table."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.ops import attention as attnops
    from puzzlelib_tpu_torch.tools.timing import handWins

    key = attnops._signature(b, h, s, d, causal, torch.bfloat16)
    attnops._attnMs[key] = (flashMs, composedMs)
    Config.recordChoice(attnops._attnChoice, key, "flash" if handWins(flashMs, composedMs, attnops.MARGIN) else "xla")


if __name__ == "__main__":
    main()
