"""Whether the library's conv backwards repeat bit for bit, and what the
deterministic algorithms cost, at the AlexNet and C3D slices' convs.

For each conv of AlexNet (f32, batch 128, ``tools/alexnetslice.py``) and of
C3D (bf16, batch 16, ``tools/c3dslice.py``), at the input shape its forward
gives it, on seeded operands: the bwd-data as a transposed conv
(``conv_transpose{2,3}d``, the form ``ops/conv.py`` takes for a strided or
grouped conv) and the bwd-filter (``torch.nn.grad.conv{2,3}d_weight``),
each under cuDNN's heuristic algorithms and under its deterministic ones:
whether three calls give the same bits, and the device ms of a call (CUDA
events, mean of 5).  ``ops/conv.py`` sends every f32 bwd-filter and
transposed conv to the deterministic algorithms on the strength of this.

Run on the card: ``python3 -m puzzlelib_tpu_torch.tools.convrepeat``; it
prints the card's name and power limit first.
"""

import torch
import torch.nn.functional as F

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.tools import alexnetslice as Alex
from puzzlelib_tpu_torch.tools import c3dslice as C3D
from puzzlelib_tpu_torch.tools import resnetslice as Res
from puzzlelib_tpu_torch.tools.timing import cardName, deviceMs


def _repeats(fn):
    first = fn()
    return all(torch.equal(first, fn()) for _ in range(2))


def _both(fn):
    """{deterministic: (repeats, ms)} of ``fn`` under each of cuDNN's modes."""
    saved, seen = torch.backends.cudnn.deterministic, {}
    try:
        for deterministic in (False, True):
            torch.backends.cudnn.deterministic = deterministic
            seen[deterministic] = (_repeats(fn), deviceMs(fn, 5))
    finally:
        torch.backends.cudnn.deterministic = saved

    return seen


def convBackwards(net, inshape, dtype, seed=1):
    """[(conv name, direction, {deterministic: (repeats, ms)})] of each conv
    of ``net`` (built unset, its convs' shapes only) for an input of
    ``inshape`` in ``dtype`` on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for conv, shape in Res.convInputs(net, inshape):
        nd = len(shape) - 2
        kw = dict(stride=conv.stride, padding=conv.pad, dilation=conv.dilation, groups=conv.groups)
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        w = torch.randn(tuple(conv.W.shape), device="cuda", generator=gen).to(dtype)
        grad = torch.randn(conv.dataShapeFrom(shape), device="cuda", generator=gen).to(dtype)

        transpose = {2: F.conv_transpose2d, 3: F.conv_transpose3d}[nd]
        weight = {2: torch.nn.grad.conv2d_weight, 3: torch.nn.grad.conv3d_weight}[nd]
        adj = tuple(n - ((g - 1) * s - 2 * p + d * (k - 1) + 1)
                    for n, g, s, p, d, k in zip(shape[2:], grad.shape[2:], conv.stride, conv.pad, conv.dilation,
                                                conv.W.shape[2:]))

        rows.append((conv.name, "bwd-data", _both(lambda: transpose(grad, w, output_padding=adj, **kw))))
        rows.append((conv.name, "bwd-filter", _both(lambda: weight(x, tuple(w.shape), grad, **kw))))
        del x, w, grad

    return rows


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the conv repeat probe needs an NVIDIA GPU")

    print(cardName())
    Config.device = "cuda"
    Config.globalEvalMode = False

    for NetSlice, dtype in ((Alex, torch.float32), (C3D, torch.bfloat16)):
        net = NetSlice.buildNet()
        inshape = (NetSlice.BATCH, ) + NetSlice.SHAPE
        for name, direction, seen in convBackwards(net, inshape, dtype):
            print("[convrepeat] %s %s %-6s %-10s heuristic: repeats %-5s %.4f ms; deterministic: repeats %-5s "
                  "%.4f ms" % (net.name, str(dtype).split(".")[-1], name, direction, seen[False][0], seen[False][1],
                               seen[True][0], seen[True][1]))
        del net
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
