"""Kernel K2: fused Winograd F(2x2, 3x3) forward conv for Hopper, hand-written
in CUDA C++ (``csrc/winograd.cu``).

Replaces ``puzzlelib_tpu/ops/pallas/winograd.py`` ``_kernel`` (wrappers
``_winogradHC``, ``conv2dNHWC`` and ``conv2d``), forward only.  ``conv2d(x, w,
pad)`` takes NCHW ``x`` and OIHW ``w`` like the reference's ``conv2d`` and
computes the 3x3 stride-1 conv by F(2x2, 3x3) on bf16, with f32 accumulation
and a bf16 output.  The design of the kernel is in the note at the top of
``csrc/winograd.cu``.

Around the kernel, in plain torch as in the reference:

- the filter transform U = G g G^T (``filterTransform``, one product with
  a constant), rounded to the weight's type, once per call;
- the layout: the kernel reads channels-last, so ``conv2d`` moves x to NHWC
  (one copy of x, free when x is already channels-last, as the output of
  this kernel is) and returns the NHWC output as an NCHW view with
  channels-last strides.  A chain of Winograd convs, with the bias, relu and
  max-pool between them, therefore stays channels-last and copies only once;
- odd output sizes: the kernel masks the last row and column of tiles, which
  is the reference's pad-to-whole-tiles-and-crop.

``plain`` is the same algorithm in plain PyTorch (unfold into 4x4 tiles,
einsum with the constant B and A matrices, crop), with the rounding points
of the kernel: each of the two butterfly stages of V = B^T d B rounded to the
input type (the kernel's butterflies are packed bf16 adds, as the
reference's are bf16), U rounded to the weight type, f32 sums.  ``conv2d``
takes it for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.  ``launches`` counts launches.

Not carried over from the TPU kernel: the row-phase slabs and lane
interleave, the VMEM block picker and its autotuner, and the compile probe.
Backward-data (the forward on the rotated filter) and the transform-domain
backward-filter (K3) come with training.
"""

import ctypes

import numpy as np
import torch

from puzzlelib_tpu_torch.ops.hopper import build


launches = 0

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

    gg = _GG.get(w.device)
    if gg is None:
        gg = _GG[w.device] = torch.from_numpy(np.kron(_G, _G)).to(w.device)

    taps = w.float().permute(2, 3, 1, 0).reshape(9, c * co)
    return torch.matmul(gg, taps).reshape(16, c, co).to(w.dtype)


def _outputShape(x, w, pad):
    n, c, h, wd = x.shape
    return n, w.shape[0], h + 2 * pad[0] - 2, wd + 2 * pad[1] - 2


def plain(x, w, pad=(0, 0)):
    """The kernel's algorithm in plain torch: NCHW x, OIHW w -> NCHW."""
    n, co, oh, ow = _outputShape(x, w, pad)
    c, h, wd = x.shape[1:]
    th, tw = -(-oh // 2), -(-ow // 2)

    # pad to whole 4x4 tiles at stride 2: 2*th + 2 rows, 2*tw + 2 columns
    xp = torch.nn.functional.pad(x.float(), (pad[1], 2 * tw + 2 - wd - pad[1],
                                             pad[0], 2 * th + 2 - h - pad[0]))
    d = xp.unfold(2, 4, 2).unfold(3, 4, 2)   # (n, c, th, tw, 4, 4)

    bt = torch.tensor(_BT, dtype=torch.float32, device=x.device)
    at = torch.tensor(_AT, dtype=torch.float32, device=x.device)

    # B^T along rows, then along columns, each stage rounded to x's type as
    # the kernel's packed bf16 butterflies round (exact for f32)
    t = torch.einsum("xa,nchwab->nchwxb", bt, d).to(x.dtype).float()
    v = torch.einsum("nchwxb,yb->nchwxy", t, bt).to(x.dtype).float()
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
    """NCHW x (N, C, H, W), w (CO, C, 3, 3) -> (N, CO, OH, OW), stride 1."""
    pad = tuple(int(p) for p in pad)
    _check(x, w, pad)

    if x.device.type == "cpu":
        return plain(x, w, pad)

    xh = x.permute(0, 2, 3, 1).contiguous()
    return conv2dNHWC(xh, filterTransform(w), pad).permute(0, 3, 1, 2)


def conv2dNHWC(xh, u, pad):
    """The kernel launch: contiguous NHWC bf16 ``xh`` on the card and U
    (16, C, CO) from ``filterTransform`` -> NHWC (N, OH, OW, CO) bf16."""
    if xh.device.type != "cuda" or u.device != xh.device:
        raise ValueError("the winograd kernel runs on CUDA tensors, got %s and %s" % (xh.device, u.device))

    if xh.dtype != torch.bfloat16 or u.dtype != torch.bfloat16:
        raise TypeError("the winograd kernel takes bf16 x and U, got %s and %s" % (xh.dtype, u.dtype))

    n, h, wd, c = xh.shape
    co = u.shape[2]
    oh, ow = h + 2 * pad[0] - 2, wd + 2 * pad[1] - 2

    if not (xh.is_contiguous() and u.is_contiguous()) or tuple(u.shape[:2]) != (16, c):
        raise ValueError("the winograd kernel takes contiguous NHWC x and (16, C, CO) U, got %s and %s" %
                         (tuple(xh.shape), tuple(u.shape)))

    if c <= 0 or c % 32 != 0 or co <= 0 or co % 64 != 0:
        raise ValueError("the winograd kernel takes C and CO positive multiples of 32 and 64, got %d and %d" %
                         (c, co))

    # channel pairs load as 4 bytes, U rows as 16
    if xh.data_ptr() % 4 != 0 or u.data_ptr() % 16 != 0:
        raise ValueError("the winograd kernel needs x 4-byte and U 16-byte aligned")

    y = torch.empty((n, oh, ow, co), dtype=xh.dtype, device=xh.device)

    with torch.cuda.device(xh.device):
        err = _entry()(xh.data_ptr(), u.data_ptr(), y.data_ptr(), n, h, wd, c, co, pad[0], pad[1],
                       torch.cuda.current_stream(xh.device).cuda_stream)

    if err != 0:
        raise RuntimeError("winograd kernel launch failed for x %s, U %s, pad %s: cudaError %d" %
                           (tuple(xh.shape), tuple(u.shape), pad, err))

    global launches
    launches += 1
    return y
