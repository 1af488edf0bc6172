"""Kernels K2 and K3: Winograd F(2x2, 3x3) for Hopper, hand-written in CUDA
C++.

K2 (``csrc/winograd.cu``) is the fused forward conv.  It replaces
``puzzlelib_tpu/ops/pallas/winograd.py`` ``_kernel`` (wrappers
``_winogradHC``, ``conv2dNHWC`` and ``conv2d``).  ``conv2d(x, w, pad)`` takes
NCHW ``x`` and OIHW ``w`` like the reference's ``conv2d`` and computes the 3x3
stride-1 conv by F(2x2, 3x3) on bf16, with f32 accumulation and a bf16
output.  ``dataGrad(dy, w, pad)`` is the stride-1 bwd-data through the same
kernel: the forward on the 180-degree-rotated, io-swapped filter at pad
``2 - pad`` (the reference's ``dataGradNHWC``).

K3 (``csrc/winograd_fg.cu``) is the transform-domain bwd-filter.  It replaces
``_fgKernel`` (wrappers ``_winogradFG`` and ``filterGradNHWC``):
``filterGrad(x, dy, pad)`` returns dW (CO, C, 3, 3) in f32 as
G^T dU G of the kernel's dU (16, C, CO).  The designs of both kernels are in
the notes at the top of their sources.

Around the kernels, in plain torch as in the reference:

- the filter transform U = G g G^T (``filterTransform``) and its adjoint
  dW = G^T dU G (``filterFromTransform``), one product each with the
  constant kron(G, G), once per call;
- the layout: the kernels read channels-last, so the wrappers move their
  NCHW operands to NHWC (one copy each, free when the tensor is already
  channels-last, as K2's output is) and ``conv2d`` returns the NHWC output as
  an NCHW view with channels-last strides.  A chain of Winograd convs, with
  the bias, relu and max-pool between them and their backward passes,
  therefore stays channels-last;
- odd output sizes: the kernels mask the last row and column of tiles, which
  is the reference's pad-to-whole-tiles-and-crop.

``plain`` and ``filterGradPlain`` are the same algorithms in plain PyTorch
(unfold into 4x4 tiles, einsum with the constant B and A matrices), with the
kernels' rounding points: each of the two butterfly stages of V = B^T d B
rounded to the input type (the kernels' butterflies are packed bf16 adds, as
the reference's are bf16), U and the gradient tile sums Mbar rounded to the
operands' type, f32 sums.  The wrappers take them for tensors on the CPU; for
CUDA tensors they launch the kernel or raise.  ``launches`` counts K2's
launches (forward and bwd-data), ``dataGradLaunches`` the bwd-data ones among
them, ``filterGradLaunches`` K3's.

Not carried over from the TPU kernels: the row-phase slabs and lane
interleave, the VMEM block pickers and their autotuner, and the compile
probes.
"""

import ctypes

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from puzzlelib_tpu_torch.ops.hopper import build


launches = 0
dataGradLaunches = 0
filterGradLaunches = 0

LANES = 128

# F(2x2, 3x3): Y = A^T [(G g G^T) . (B^T d B)] A
_BT = ((1, 0, -1, 0), (0, 1, 1, 0), (0, -1, 1, 0), (0, 1, 0, -1))
_AT = ((1, 1, 1, 0), (0, 1, -1, -1))
_G = np.array([[1, 0, 0], [.5, .5, .5], [.5, -.5, .5], [0, 0, 1]], np.float32)

# kron(G, G) (16, 9) per device, built once: a tensor made on the card from
# host values is a pageable copy that waits for all the work queued before it
_GG = {}


def applicable(xshape, wshape, stride, pad, dilation, groups):
    """Static eligibility (NCHW shapes): 3x3, stride 1, dilation 1, groups 1,
    C and CO multiples of 128, at least a 2x2 output.  The reference's rule
    less its VMEM clause."""
    if len(xshape) != 4 or groups != 1:
        return False

    if any(s != 1 for s in stride) or any(d != 1 for d in dilation):
        return False

    n, c, h, w = xshape
    co, ci, kh, kw = wshape

    if (kh, kw) != (3, 3) or c % LANES != 0 or co % LANES != 0:
        return False

    oh = h + 2 * pad[0] - 2
    ow = w + 2 * pad[1] - 2
    return oh >= 2 and ow >= 2


def filterTransform(w):
    """(CO, C, 3, 3) -> U (16, C, CO) = G g G^T per (c, o), in f32, rounded
    to w's type: one (16, 9) @ (9, C * CO) product with kron(G, G), whose
    entries (0, +-1/4, 1/2, 1) scale each tap exactly."""
    co, c = w.shape[:2]

    taps = w.float().permute(2, 3, 1, 0).reshape(9, c * co)
    return torch.matmul(_kronG(w.device), taps).reshape(16, c, co).to(w.dtype)


def filterFromTransform(du):
    """dU (16, C, CO) f32 -> dW (CO, C, 3, 3) f32 = G^T dU G per (c, o): the
    adjoint of ``filterTransform``, one (9, 16) @ (16, C * CO) product."""
    c, co = du.shape[1:]

    taps = torch.matmul(_kronG(du.device).t(), du.reshape(16, c * co))
    return taps.reshape(3, 3, c, co).permute(3, 2, 0, 1)


def _kronG(device):
    gg = _GG.get(device)
    if gg is None:
        gg = _GG[device] = torch.from_numpy(np.kron(_G, _G)).to(device)

    return gg


def _outputShape(x, w, pad):
    n, c, h, wd = x.shape
    return n, w.shape[0], h + 2 * pad[0] - 2, wd + 2 * pad[1] - 2


def _inputTransform(x, pad, th, tw):
    """V = B^T d B of every 4x4 tile (stride 2) of NCHW x padded by ``pad``
    and to whole tiles: (n, c, th, tw, 4, 4) f32.  B^T along rows, then along
    columns, each stage rounded to x's type as the kernels' packed bf16
    butterflies round (exact for f32)."""
    h, wd = x.shape[2:]

    # pad to whole 4x4 tiles at stride 2: 2*th + 2 rows, 2*tw + 2 columns
    xp = torch.nn.functional.pad(x.float(), (pad[1], 2 * tw + 2 - wd - pad[1],
                                             pad[0], 2 * th + 2 - h - pad[0]))
    d = xp.unfold(2, 4, 2).unfold(3, 4, 2)   # (n, c, th, tw, 4, 4)

    bt = torch.tensor(_BT, dtype=torch.float32, device=x.device)
    t = torch.einsum("xa,nchwab->nchwxb", bt, d).to(x.dtype).float()
    return torch.einsum("nchwxb,yb->nchwxy", t, bt).to(x.dtype).float()


def plain(x, w, pad=(0, 0)):
    """The kernel's algorithm in plain torch: NCHW x, OIHW w -> NCHW."""
    n, co, oh, ow = _outputShape(x, w, pad)
    c = x.shape[1]
    th, tw = -(-oh // 2), -(-ow // 2)

    at = torch.tensor(_AT, dtype=torch.float32, device=x.device)
    v = _inputTransform(x, pad, th, tw)
    u = filterTransform(w).float().reshape(4, 4, c, co)

    m = torch.einsum("nchwxy,xyco->nohwxy", v, u)
    y = torch.einsum("ax,nohwxy,by->nohawb", at, m, at)   # (n, co, th, 2, tw, 2)

    return y.reshape(n, co, 2 * th, 2 * tw)[:, :, :oh, :ow].to(x.dtype)


def _entry():
    fn = build.load("winograd").pl_winograd_f23
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, w, pad):
    if x.device != w.device:
        raise ValueError("winograd conv operands on %s and %s" % (x.device, w.device))

    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[1:]) != (x.shape[1], 3, 3):
        raise ValueError("winograd conv takes NCHW x and (CO, C, 3, 3) w, got %s and %s" %
                         (tuple(x.shape), tuple(w.shape)))

    if len(pad) != 2 or min(pad) < 0:
        raise ValueError("winograd conv takes two non-negative paddings, got %s" % (pad, ))

    n, co, oh, ow = _outputShape(x, w, pad)
    if oh < 1 or ow < 1:
        raise ValueError("winograd conv of %s with pad %s has no output" % (tuple(x.shape), pad))


def conv2d(x, w, pad=(0, 0)):
    """NCHW x (N, C, H, W), w (CO, C, 3, 3) -> (N, CO, OH, OW), stride 1.
    A fake tensor (a ``torch.export`` trace) goes to the custom operator
    ``conv2dOp``, which the trace records."""
    if is_fake(x):
        return conv2dOp(x, w, list(pad))

    pad = tuple(int(p) for p in pad)
    _check(x, w, pad)

    return _conv2d(x, w, pad, dataGrad=False)


def _conv2d(x, w, pad, dataGrad):
    if x.device.type == "cpu":
        return plain(x, w, pad)

    xh = x.permute(0, 2, 3, 1).contiguous()
    return conv2dNHWC(xh, filterTransform(w), pad, dataGrad).permute(0, 3, 1, 2)


@torch.library.custom_op("puzzlelib::winograd_conv2d", mutates_args=())
def conv2dOp(x: torch.Tensor, w: torch.Tensor, pad: list[int]) -> torch.Tensor:
    """``conv2d`` registered as the custom operator
    ``puzzlelib::winograd_conv2d``, with a shape function, as
    ``matmul.matmulOp`` is: ``conv2d`` hands it the fake tensors of a
    ``torch.export`` trace, so that an engine's graph records K2."""
    return conv2d(x, w, pad)


@conv2dOp.register_fake
def _conv2dShape(x, w, pad):
    pad = tuple(int(p) for p in pad)
    _check(x, w, pad)

    # the kernel's NHWC output seen as NCHW: channels-last strides
    return torch.empty(_outputShape(x, w, pad), dtype=x.dtype, device=x.device, memory_format=torch.channels_last)


# K2's blocking (csrc/winograd.cu): input channels per step, output channels
# per block
K2_BK, K2_BN = 32, 128


def conv2dNHWC(xh, u, pad, dataGrad=False):
    """The kernel launch: contiguous NHWC bf16 ``xh`` on the card and U
    (16, C, CO) from ``filterTransform`` -> NHWC (N, OH, OW, CO) bf16.
    ``dataGrad`` marks a bwd-data launch for its own count.  The operands'
    types, shapes and channel counts are checked before their device."""
    if xh.dtype != torch.bfloat16 or u.dtype != torch.bfloat16:
        raise TypeError("the winograd kernel takes bf16 x and U, got %s and %s" % (xh.dtype, u.dtype))

    n, h, wd, c = xh.shape
    co = u.shape[2]
    oh, ow = h + 2 * pad[0] - 2, wd + 2 * pad[1] - 2

    if not (xh.is_contiguous() and u.is_contiguous()) or tuple(u.shape[:2]) != (16, c):
        raise ValueError("the winograd kernel takes contiguous NHWC x and (16, C, CO) U, got %s and %s" %
                         (tuple(xh.shape), tuple(u.shape)))

    if c <= 0 or c % K2_BK != 0 or co <= 0 or co % K2_BN != 0:
        raise ValueError("the winograd kernel takes C and CO positive multiples of %d and %d, got %d and %d" %
                         (K2_BK, K2_BN, c, co))

    if xh.device.type != "cuda" or u.device != xh.device:
        raise ValueError("the winograd kernel runs on CUDA tensors, got %s and %s" % (xh.device, u.device))

    # x and U load as 16-byte units
    if xh.data_ptr() % 16 != 0 or u.data_ptr() % 16 != 0:
        raise ValueError("the winograd kernel needs x and U 16-byte aligned")

    y = torch.empty((n, oh, ow, co), dtype=xh.dtype, device=xh.device)

    with torch.cuda.device(xh.device):
        err = _entry()(xh.data_ptr(), u.data_ptr(), y.data_ptr(), n, h, wd, c, co, pad[0], pad[1],
                       torch.cuda.current_stream(xh.device).cuda_stream)

    if err != 0:
        raise RuntimeError("winograd kernel launch failed for x %s, U %s, pad %s: cudaError %d" %
                           (tuple(xh.shape), tuple(u.shape), pad, err))

    global launches, dataGradLaunches
    launches += 1
    dataGradLaunches += dataGrad
    return y


def dataGrad(dy, w, pad=(0, 0)):
    """bwd-data of the 3x3 stride-1 conv through K2: NCHW dy (N, CO, OH, OW)
    and the forward's w (CO, C, 3, 3) -> dX (N, C, OH - 2 pad + 2, ...).
    The forward conv of dy with the 180-degree-rotated, io-swapped filter at
    pad ``2 - pad``."""
    pad = tuple(int(p) for p in pad)
    if len(pad) != 2 or max(pad) > 2:
        raise ValueError("winograd bwd-data takes two paddings of at most 2, got %s" % (pad, ))

    wT, padT = w.flip((2, 3)).transpose(0, 1), (2 - pad[0], 2 - pad[1])
    _check(dy, wT, padT)
    return _conv2d(dy, wT, padT, dataGrad=True)


# K3's blocking (csrc/winograd_fg.cu): input channels and output channels per
# block, tiles per step at most, whole tile rows per step at most
FG_BM, FG_BN, FG_KT, FG_RMAX = 64, 128, 32, 8

_SMS = {}


def filterGradApplicable(xshape, dyshape, stride, pad, dilation, groups):
    """Static eligibility for the transform-domain bwd-filter (NCHW shapes):
    3x3 (read off the shapes), stride 1, dilation 1, groups 1, C and CO
    multiples of 128.  The reference's rule less its VMEM clause."""
    if len(xshape) != 4 or len(dyshape) != 4 or groups != 1:
        return False

    if any(s != 1 for s in stride) or any(d != 1 for d in dilation):
        return False

    n, c, h, w = xshape
    co, oh, ow = dyshape[1:]

    if (h + 2 * pad[0] - oh, w + 2 * pad[1] - ow) != (2, 2):
        return False

    return c % LANES == 0 and co % LANES == 0 and oh >= 1 and ow >= 1


def _checkFG(x, dy, pad):
    if x.device != dy.device:
        raise ValueError("winograd bwd-filter operands on %s and %s" % (x.device, dy.device))

    if len(pad) != 2 or min(pad) < 0:
        raise ValueError("winograd bwd-filter takes two non-negative paddings, got %s" % (pad, ))

    if x.dim() != 4 or dy.dim() != 4 or dy.shape[0] != x.shape[0] or min(dy.shape[2:]) < 1 or \
            tuple(dy.shape[2:]) != (x.shape[2] + 2 * pad[0] - 2, x.shape[3] + 2 * pad[1] - 2):
        raise ValueError("winograd bwd-filter takes NCHW x and the gradient of its 3x3 conv at pad %s, "
                         "got %s and %s" % (pad, tuple(x.shape), tuple(dy.shape)))


def _gradTransform(dy, th, tw):
    """Mbar = A dY A^T of every 2x2 gradient tile of NCHW dy, zero past the
    odd edges: (4, 4, n, co, th, tw) in dy's type, Mbar[xi nu] the signed
    dY terms of A^T's columns xi (rows, outer) and nu (columns, inner),
    added one by one in dy's type."""
    n, co, oh, ow = dy.shape
    g = torch.nn.functional.pad(dy, (0, 2 * tw - ow, 0, 2 * th - oh)).reshape(n, co, th, 2, tw, 2)

    acol = [[(a, _AT[a][xi]) for a in range(2) if _AT[a][xi] != 0] for xi in range(4)]
    mbar = []
    for xi in range(4):
        for nu in range(4):
            m = None
            for a, sa in acol[xi]:
                for b, sb in acol[nu]:
                    term = g[:, :, :, a, :, b] * (sa * sb)
                    m = term if m is None else m + term
            mbar.append(m)

    return torch.stack(mbar).reshape(4, 4, n, co, th, tw)


def filterGradPlain(x, dy, pad=(0, 0)):
    """K3's algorithm in plain torch: NCHW x (N, C, H, W) and dy
    (N, CO, OH, OW) -> dW (CO, C, 3, 3) f32, with the kernel's rounding
    points: V as in the forward; Mbar[xi nu] = sum of the signed dY terms of
    A^T's columns xi and nu, added one by one in dy's type in the reference's
    order (``_ACOL[xi]`` outer, ``_ACOL[nu]`` inner); f32 sums over tiles."""
    n, c = x.shape[:2]
    co, oh, ow = dy.shape[1:]
    th, tw = -(-oh // 2), -(-ow // 2)

    v = _inputTransform(x, pad, th, tw)
    m = _gradTransform(dy, th, tw).float()
    du = torch.einsum("nchwxy,xynohw->xyco", v, m).reshape(16, c, co)
    return filterFromTransform(du)


def filterGrad(x, dy, pad=(0, 0)):
    """NCHW x (N, C, H, W) and the gradient dy (N, CO, OH, OW) of its 3x3
    stride-1 conv at ``pad`` -> dW (CO, C, 3, 3) f32 (before the cast to the
    weight's type)."""
    pad = tuple(int(p) for p in pad)
    _checkFG(x, dy, pad)

    if x.device.type == "cpu":
        return filterGradPlain(x, dy, pad)

    xh = x.permute(0, 2, 3, 1).contiguous()
    dyh = dy.permute(0, 2, 3, 1).contiguous()
    return filterFromTransform(filterGradNHWC(xh, dyh, pad))


def _entryFG():
    fn = build.load("winograd_fg").pl_winograd_fg
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _stepGeometry(n, th, tw):
    """How K3 cuts the n * th rows of tw tiles into steps (the rule of
    ``pl_winograd_fg_steps`` in csrc/winograd_fg.cu): a row longer than
    ``FG_KT`` tiles in ``segs`` runs of ``length`` tiles (the last may be
    shorter), else up to ``FG_RMAX`` whole rows a step.  Returns (length,
    runs, segs, steps)."""
    segs = -(-tw // FG_KT)
    length = -(-tw // segs)
    runs = 1 if segs > 1 else min(FG_KT // tw, FG_RMAX)
    return length, runs, segs, -(-(n * th) // runs) * segs


def _tileChunk(steps, c, co, sms):
    """Steps per split of K3's tile axis: as many splits as fill about two
    waves of blocks (one block fits an SM, ``4 * (c / 64) * (co / 128)``
    blocks a split), at least 4 steps a split."""
    blocks = 4 * (c // FG_BM) * (co // FG_BN)
    splits = max(1, 2 * sms // blocks)
    return max(-(-steps // splits), 4)


def _smCount(device):
    sms = _SMS.get(device)
    if sms is None:
        sms = _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count

    return sms


def filterGradNHWC(xh, dyh, pad):
    """The kernel launch: contiguous NHWC bf16 ``xh`` (N, H, W, C) and
    ``dyh`` (N, OH, OW, CO) on the card -> dU (16, C, CO) f32."""
    if xh.dtype != torch.bfloat16 or dyh.dtype != torch.bfloat16:
        raise TypeError("the winograd bwd-filter kernel takes bf16 x and dy, got %s and %s" % (xh.dtype, dyh.dtype))

    n, h, wd, c = xh.shape
    oh, ow, co = dyh.shape[1:]

    if not (xh.is_contiguous() and dyh.is_contiguous()) or \
            tuple(dyh.shape) != (n, h + 2 * pad[0] - 2, wd + 2 * pad[1] - 2, co) or min(oh, ow) < 1:
        raise ValueError("the winograd bwd-filter kernel takes contiguous NHWC x and the gradient of its 3x3 "
                         "conv at pad %s, got %s and %s" % (pad, tuple(xh.shape), tuple(dyh.shape)))

    if c <= 0 or c % FG_BM != 0 or co <= 0 or co % FG_BN != 0:
        raise ValueError("the winograd bwd-filter kernel takes C and CO positive multiples of %d and %d, "
                         "got %d and %d" % (FG_BM, FG_BN, c, co))

    if xh.device.type != "cuda" or dyh.device != xh.device:
        raise ValueError("the winograd bwd-filter kernel runs on CUDA tensors, got %s and %s" %
                         (xh.device, dyh.device))

    # 8-channel chunks load as 16 bytes
    if xh.data_ptr() % 16 != 0 or dyh.data_ptr() % 16 != 0:
        raise ValueError("the winograd bwd-filter kernel needs x and dy 16-byte aligned")

    steps = _stepGeometry(n, -(-oh // 2), -(-ow // 2))[3]
    chunk = _tileChunk(steps, c, co, _smCount(xh.device))
    splits = -(-steps // chunk)

    du = torch.empty((16, c, co), dtype=torch.float32, device=xh.device)
    work = torch.empty((splits, 16, c, co), dtype=torch.float32, device=xh.device) if splits > 1 else None

    with torch.cuda.device(xh.device):
        err = _entryFG()(xh.data_ptr(), dyh.data_ptr(), du.data_ptr(), None if work is None else work.data_ptr(),
                         n, h, wd, c, co, pad[0], pad[1], chunk, torch.cuda.current_stream(xh.device).cuda_stream)

    if err != 0:
        raise RuntimeError("winograd bwd-filter kernel launch failed for x %s, dy %s, pad %s: cudaError %d" %
                           (tuple(xh.shape), tuple(dyh.shape), pad, err))

    global filterGradLaunches
    filterGradLaunches += 1
    return du
