"""N-dimensional convolution in NCHW layout, forward and backward
(counterpart of ``puzzlelib_tpu/ops/conv.py``).

While ``Config.convAlgo`` is "hopper", a bf16 conv on CUDA tensors goes to a
hand-written kernel where one takes it, and everything else to the library
call, the counterpart of the reference's ``lax`` convs.  Under "auto" each
direction of such a conv goes to the kernel only where ``measureAlgoChoice``
(``optimizeForShape``) recorded it in ``_algoChoice``, and to the library
where it recorded the library or nothing:

- forward: ``_convCore`` sends what ``winograd.applicable`` takes to K2,
  the rest to ``torch.nn.functional.conv{1,2,3}d``;
- bwd-data: the stride-1 transposed conv is a plain conv of the gradient
  with the rotated, io-swapped filter, so ``_transposedConv`` sends what
  ``_convCore``'s rule takes to K2 (``winograd.dataGrad``); the strided or
  dilated remainder goes to ``torch.nn.functional.conv_transpose{1,2,3}d``,
  and so does a gradient narrower than the kernel along an axis
  (``_narrowerThanKernel``), which the plain conv would pad by nearly the
  kernel's width on both sides (SentiNet's filters span the embedding, so
  its gradient has one column: 608 ms a call against 0.56 on an H100);
- bwd-filter: ``_filterGrad`` sends what ``winograd.filterGradApplicable``
  takes to K3 (``winograd.filterGrad``), the rest to the library's
  bwd-filter (``torch.nn.grad.conv{1,2,3}d_weight``).  A 1-d one, an f32
  one, and one whose output is narrower than its kernel (a 1-d conv in
  effect), takes cuDNN's deterministic algorithms, as does the transposed
  conv of such a gradient and of any f32 gradient, so that each repeats
  bit for bit: the heuristic's picks for them add with atomics (AlexNet's
  f32 convs' bwd-data at every conv, and conv1's bwd-filter, gave other
  bits at each call on an H100; its bf16 and 3-d convs repeat).

The deconvolution (transposed conv, cuDNN-style: its forward is the conv's
bwd-data) reuses the three: ``deconvNd`` is ``_transposedConv`` with
``postpad`` as the stride adjustment, so a stride-1 3x3 deconv whose
channels are multiples of 128 goes to K2 through ``winograd.dataGrad``; its
bwd-data is ``_convCore`` (K2 where it takes the conv); its bwd-filter is
``_filterGrad`` with the roles of input and gradient swapped (K3 where it
takes it).  U-Net's 2x2 stride-2 deconvs go to
``torch.nn.functional.conv_transpose2d`` and the library's bwd-filter.

The bias gradient is a sum in f32 cast back to the gradient's type, as in
the reference.

``_algoChoice`` is keyed by direction and by the shapes the kernel sees:
("fwd", x, w, pad) and ("fg", x, dy, pad) as the reference keys them, and
("bwdData", dy, the rotated w, its pad) for the bwd-data, which the
reference records under the forward key of that rotated conv, since there
one kernel runs both.  Here K2 and K2-bwd are two kernels with costs of
their own, raced against two library calls, so for a square C -> C conv
the two races can come out apart: the bwd-data is a direction of its own.
A deconvolution's directions are these three kernels' in other roles and
read the same keys.
"""

import contextlib

import torch
import torch.nn.functional as F

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.backend.device import getDevice
from puzzlelib_tpu_torch.ops.hopper import winograd
from puzzlelib_tpu_torch.tools import timing


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_TRANSPOSE = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}
_CONV_WEIGHT = {1: torch.nn.grad.conv1d_weight, 2: torch.nn.grad.conv2d_weight, 3: torch.nn.grad.conv3d_weight}


# measured per-direction choices ("hopper" or "torch"), filled by
# measureAlgoChoice; the times of each race in ms (hand, library) beside them
_algoChoice = {}
_algoMs = {}

# the race's margin: the hand kernel only below 0.97x the library (conv.py:282)
MARGIN = 0.97


def _kernelMay(*tensors):
    """True where ``Config.convAlgo`` lets a hand kernel take a conv of these
    tensors: 2-d, bf16, on the card, the algo "hopper" or "auto"."""
    return (tensors[0].dim() == 4 and tensors[0].is_cuda and Config.checkAlgo(Config.convAlgo) != "torch"
            and all(t.dtype == torch.bfloat16 for t in tensors))


def _routed(key):
    return Config.route(Config.convAlgo, _algoChoice, key)


def _useWinograd(x, wshape, stride, pad, dilation, groups):
    return _kernelMay(x) and winograd.applicable(tuple(x.shape), tuple(wshape), stride, pad, dilation, groups)


def _convLibrary(x, w, stride, pad, dilation, groups):
    return _CONV[x.dim() - 2](x, w, stride=stride, padding=pad, dilation=dilation, groups=groups)


def _convCore(x, w, stride, pad, dilation, groups):
    if (w.dtype == x.dtype and _useWinograd(x, w.shape, stride, pad, dilation, groups)
            and _routed(("fwd", tuple(x.shape), tuple(w.shape), tuple(pad)))):
        return winograd.conv2d(x, w, pad)

    return _convLibrary(x, w, stride, pad, dilation, groups)


def _narrowerThanKernel(spatial, size, dilation):
    """True where ``spatial`` (a conv's output extent) has fewer cells
    along an axis than the dilated kernel spans."""
    return any(n < d * (k - 1) + 1 for n, k, d in zip(spatial, size, dilation))


def kernelLayout(x, wshape, stride, pad, dilation, groups):
    """x in the memory layout that the conv's kernels read: channels-last
    where K2 takes the conv, so that its forward and K3 on the same input copy
    nothing; else x as it is.  Under "auto" the layout follows from the
    shapes alone, not from the race: both candidates are raced on it."""
    if _useWinograd(x, wshape, stride, pad, dilation, groups):
        return x.contiguous(memory_format=torch.channels_last)

    return x


def convNd(x, w, b, stride, pad, dilation, groups):
    out = _convCore(x, w, stride, pad, dilation, groups)

    if b is not None:
        out = out + b.reshape((1, b.numel()) + (1, ) * (x.dim() - 2)).to(out.dtype)

    return out


# -- bwd-filter ------------------------------------------------------------------

@contextlib.contextmanager
def _cudnnDeterministic():
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def _filterGrad(x, grad, wshape, stride, pad, dilation, groups):
    """dW (outmaps, inmaps // groups, *size) of the forward conv: K3 where
    it takes the conv and ``Config.convAlgo`` routes it there, else
    ``_filterGradLibrary``."""
    if (_kernelMay(x, grad) and winograd.filterGradApplicable(tuple(x.shape), tuple(grad.shape), stride, pad,
                                                              dilation, groups)
            and _routed(("fg", tuple(x.shape), tuple(grad.shape), tuple(pad)))):
        return winograd.filterGrad(x, grad, pad)

    return _filterGradLibrary(x, grad, wshape, stride, pad, dilation, groups)


def _filterGradLibrary(x, grad, wshape, stride, pad, dilation, groups):
    """The library's bwd-filter.  A 1-d conv's, an f32 one, and that of a
    conv whose output is narrower than its kernel, takes cuDNN's
    deterministic algorithms: the ones its heuristic picks for the IMDB
    CNN's and SentiNet's f32 convs and AlexNet's conv1 add with atomics and
    gave other bits at each call on an H100."""
    nd = x.dim() - 2
    deterministic = (nd == 1 or x.dtype == torch.float32
                     or _narrowerThanKernel(tuple(grad.shape[2:]), wshape[2:], dilation))
    with _cudnnDeterministic() if deterministic else contextlib.nullcontext():
        return _CONV_WEIGHT[nd](x, wshape, grad, stride=stride, padding=pad, dilation=dilation, groups=groups)


def _biasGrad(grad):
    axes = (0, ) + tuple(range(2, grad.dim()))
    return grad.float().sum(dim=axes).to(grad.dtype)


def convNdBackwardParams(x, grad, w, stride, pad, dilation, groups, hasBias=False):
    """(dW in w's type, db in grad's type or None)."""
    dw = _filterGrad(x, grad, tuple(w.shape), stride, pad, dilation, groups).to(w.dtype)
    return dw, _biasGrad(grad) if hasBias else None


# -- bwd-data --------------------------------------------------------------------

def _rotated(w):
    """The kernel of the plain conv that is the stride-1 transposed conv
    of w (outmaps, inmaps, *size): flipped and io-swapped."""
    return torch.flip(w, tuple(range(2, w.dim()))).transpose(0, 1)


def _plainPad(size, stride, pad, dilation, adj, groups):
    """The padding of the plain conv that the transposed conv is where it is
    one (stride 1, no adjustment, one group, no negative padding), else
    None."""
    padT = tuple(d * (k - 1) - p for k, p, d in zip(size, pad, dilation))
    plain = all(s == 1 for s in stride) and all(a == 0 for a in adj) and groups == 1 and min(padT) >= 0
    return padT if plain else None


def _transposedConv(y, w, stride, pad, dilation, adj, groups):
    """Map y (N, outmaps, *yspatial) back through the forward conv's kernel
    w (outmaps, inmaps // groups, *size).  ``adj`` is the extra high padding
    per axis that recovers the sizes lost to the stride's flooring.

    The stride-1 transposed conv IS a plain conv of y with the flipped,
    io-swapped kernel: K2 (``winograd.dataGrad``) where it takes that conv
    and ``Config.convAlgo`` routes its bwd-data there, else
    ``_dataGradLibrary``."""
    nd = y.dim() - 2
    size = tuple(w.shape[2:])
    padT = _plainPad(size, stride, pad, dilation, adj, groups)

    if padT is not None:
        wshapeT = (w.shape[1], w.shape[0]) + size
        if (w.dtype == y.dtype and _useWinograd(y, wshapeT, (1, ) * nd, padT, dilation, 1)
                and _routed(("bwdData", tuple(y.shape), wshapeT, padT))):
            return winograd.dataGrad(y, w, pad)

    return _dataGradLibrary(y, w, stride, pad, dilation, adj, groups)


def _dataGradLibrary(y, w, stride, pad, dilation, adj, groups):
    """The library's transposed conv: the stride-1 one as the plain conv of
    y with the rotated kernel, unless y is narrower than the kernel, which
    the plain conv would pad by nearly the kernel's width on both sides; the
    rest as ``conv_transpose``."""
    nd = y.dim() - 2
    size = tuple(w.shape[2:])
    padT = _plainPad(size, stride, pad, dilation, adj, groups)

    narrow = _narrowerThanKernel(tuple(y.shape[2:]), size, dilation)
    if padT is not None and not narrow:
        return _CONV[nd](y, _rotated(w), padding=padT, dilation=dilation)

    # the heuristic's bwd-data algorithms add with atomics for every f32 conv
    # of AlexNet that reaches here (strided or grouped) on an H100
    with _cudnnDeterministic() if narrow or y.dtype == torch.float32 else contextlib.nullcontext():
        return _CONV_TRANSPOSE[nd](y, w, stride=stride, padding=pad, output_padding=adj, groups=groups,
                                   dilation=dilation)


# -- the race -------------------------------------------------------------------

def _gradShape(datashape, Wshape, stride, pad, dilation):
    """The 2-d conv's output (N, CO, OH, OW)."""
    n, _, h, wd = datashape
    co, _, kh, kw = Wshape
    oh = (h + 2 * pad[0] - dilation[0] * (kh - 1) - 1) // stride[0] + 1
    ow = (wd + 2 * pad[1] - dilation[1] * (kw - 1) - 1) // stride[1] + 1
    return (n, co, oh, ow)


def raceKeys(datashape, Wshape, stride, pad, dilation, groups):
    """{direction: its ``_algoChoice`` key} for each direction of this conv
    that a hand kernel takes (``measureAlgoChoice``'s races)."""
    datashape, Wshape = tuple(datashape), tuple(Wshape)
    stride, pad, dilation = tuple(stride), tuple(pad), tuple(dilation)

    if len(datashape) != 4:
        return {}

    c, kh, kw = datashape[1], Wshape[2], Wshape[3]
    dyshape, wshapeT = _gradShape(datashape, Wshape, stride, pad, dilation), (c, Wshape[0], kh, kw)
    padT = _plainPad((kh, kw), stride, pad, dilation, (0, 0), groups)

    keys = {}
    if winograd.applicable(datashape, Wshape, stride, pad, dilation, groups):
        keys["fwd"] = ("fwd", datashape, Wshape, pad)
    if winograd.filterGradApplicable(datashape, dyshape, stride, pad, dilation, groups):
        keys["fg"] = ("fg", datashape, dyshape, pad)
    if padT is not None and winograd.applicable(dyshape, wshapeT, (1, 1), padT, dilation, 1):
        keys["bwdData"] = ("bwdData", dyshape, wshapeT, padT)

    return keys


def measureAlgoChoice(datashape, Wshape, stride, pad, dilation, groups, dtype=torch.bfloat16, reps=10, k=3):
    """Race each hand kernel that takes this 2-d conv against the library
    call that runs in its place, and record the faster in ``_algoChoice``
    (the reference's cuDNN algo-search counterpart, ``conv.py:183-343``):

      fwd      K2 ``winograd.conv2d``       against ``_convLibrary``
      fg       K3 ``winograd.filterGrad``   against ``_filterGradLibrary``
      bwdData  K2 ``winograd.dataGrad``     against ``_dataGradLibrary``
               (the rotated-kernel plain conv), keyed apart from the fwd

    Both candidates run on the same seeded operands, in the layout the net
    hands them (x and dy channels-last, as ``kernelLayout`` keeps them),
    timed in ``k`` alternating turns of ``reps`` calls, the least turn of
    each; the hand kernel is recorded only below ``MARGIN`` times the
    library.  Returns {direction: (choice, hand ms, library ms)}; None where
    no kernel takes the conv (not 2-d, not bf16, not 3x3 stride 1 at its
    widths) and on the CPU, recording nothing.  A race that fails raises."""
    keys = raceKeys(datashape, Wshape, stride, pad, dilation, groups)
    device = getDevice()
    if dtype != torch.bfloat16 or not keys or not timing.raceable(device):
        return None

    datashape, Wshape = tuple(datashape), tuple(Wshape)
    stride, pad, dilation = tuple(stride), tuple(pad), tuple(dilation)
    gen = torch.Generator(device=device).manual_seed(0)

    def draw(shape, scale):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    x = draw(datashape, 0.3).contiguous(memory_format=torch.channels_last)
    w = draw(Wshape, 0.1)
    dy = draw(_gradShape(datashape, Wshape, stride, pad, dilation), 0.1).contiguous(
        memory_format=torch.channels_last)

    races = {
        "fwd": (lambda: winograd.conv2d(x, w, pad), lambda: _convLibrary(x, w, stride, pad, dilation, groups)),
        "fg": (lambda: winograd.filterGrad(x, dy, pad),
               lambda: _filterGradLibrary(x, dy, Wshape, stride, pad, dilation, groups)),
        "bwdData": (lambda: winograd.dataGrad(dy, w, pad),
                    lambda: _dataGradLibrary(dy, w, stride, pad, dilation, (0, 0), groups)),
    }

    results = {}
    for direction, key in keys.items():
        hand, library = races[direction]
        times = timing.race({"hopper": hand, "torch": library}, reps, k)
        choice = "hopper" if timing.handWins(times["hopper"], times["torch"], MARGIN) else "torch"

        _algoMs[key] = (times["hopper"], times["torch"])
        Config.recordChoice(_algoChoice, key, choice)
        results[direction] = (choice, times["hopper"], times["torch"])

    return results


def resetDispatchCaches():
    """Forget every measured choice: the conv table, the GEMM table
    (``ops.hopper.matmul._dispatch``) and the attention table
    (``ops.attention._attnChoice``), with their times; "auto" then takes
    each direction's prior again.  The reference's probe caches have no
    counterpart here."""
    from puzzlelib_tpu_torch.ops import attention
    from puzzlelib_tpu_torch.ops.hopper import matmul

    Config.clearChoices(_algoChoice, _algoMs, matmul._dispatch, matmul._tunedSecs, matmul._raceMs,
                        attention._attnChoice, attention._attnMs)


def _strideAdjust(inspatial, size, stride, pad, dilation):
    """Per-axis remainder lost by the forward conv's stride flooring."""
    return tuple(
        inspatial[i] + 2 * pad[i] - (dilation[i] * (size[i] - 1) + 1)
        - stride[i] * ((inspatial[i] + 2 * pad[i] - dilation[i] * (size[i] - 1) - 1) // stride[i])
        for i in range(len(size))
    )


def convNdBackwardData(grad, w, xshape, stride, pad, dilation, groups):
    adj = _strideAdjust(xshape[2:], tuple(w.shape[2:]), stride, pad, dilation)
    return _transposedConv(grad, w, stride, pad, dilation, adj, groups).to(grad.dtype)


# -- deconvolution ---------------------------------------------------------------

def deconvNd(x, w, b, stride, pad, dilation, postpad, groups):
    """The transposed conv of x (N, inmaps, *spatial) with w (inmaps, outmaps
    // groups, *size), the forward conv kernel of the reverse direction, plus
    the bias."""
    out = _transposedConv(x, w, stride, pad, dilation, postpad, groups).to(x.dtype)

    if b is not None:
        out = out + b.reshape((1, b.numel()) + (1, ) * (x.dim() - 2)).to(out.dtype)

    return out


def deconvNdBackwardData(grad, w, stride, pad, dilation, groups):
    """The deconv's input gradient: the plain forward conv of grad with w,
    which is (O = inmaps, I = outmaps // groups) for that direction."""
    return _convCore(grad, w, stride, pad, dilation, groups)


def deconvNdBackwardParams(x, grad, w, stride, pad, dilation, groups, hasBias=False):
    """(dW in w's type, db in grad's type or None): the deconv is the conv
    that maps grad's space to x's, so dW is that conv's filter gradient."""
    dw = _filterGrad(grad, x, tuple(w.shape), stride, pad, dilation, groups).to(w.dtype)
    return dw, _biasGrad(grad) if hasBias else None
