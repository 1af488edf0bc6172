"""Probe P1: the pitch-row tap-dot direct conv, hand-written in CUDA C++
(``csrc/tapdot.cu``).

Replaces ``tools/tapdot_probe.py`` ``_kernel`` (through ``tapdot`` and
``conv2d``), the Pallas kernel that runs a stride-1 conv as kh * kw MXU dots
on row-shifted views of an input slab.  The input is NHWC with each image's
padded rows flattened at pitch wp = OW + kw - 1, so filter tap (r, s) is the
row shift r wp + s:

    out[n, g, :] = sum over (r, s) of xp[n, g + r wp + s, :] @ wk[r kw + s]

for every output row g < nTiles * bi * wp, summed in f32 and rounded once to
the input's type.  ``tapdot(xp, wk, bi, wp, kh, kw, c, co, nTiles)`` takes
xp (N, rows, C) and wk (kh kw, C, CO) and returns (N, nTiles bi wp, CO);
``conv2d(x, w, pad, bi=None)`` is the NCHW wrapper of the probe, with its
choice of ``bi``, its pitch padding and its crop.  The kernel runs bf16 and
f16 on the tensor cores and takes C and CO in multiples of 16; f32 on the
card raises ``TypeError``.  ``bi`` is the TPU program's tile of output rows:
it sets how many rows are computed (the crop removes the extra), not how the
kernel tiles, which the note at the top of the source describes.

On a CUDA tensor ``tapdot`` launches the ``wgmma`` kernel fed by TMA: blocks
of 256 output rows by 128 output channels, the slab of input rows held
unswizzled and K-major so that each tap's shift is an offset on a
shared-memory descriptor.  The first kernel, on ``mma.sync``, stays in the
source as the yardstick that ``chip_smoke.py`` times beside it, reached
only through ``_launch``'s private ``path`` argument.

P1 is a probe, the direct-conv alternative to K2 that the card is asked
about; no ``Config.convAlgo`` route reaches it, as none does in the JAX
package.

``plain`` is the same kh kw shifted products in f32 with ``torch.matmul``,
rounded once.  ``tapdot`` takes it for tensors on the CPU, where no kernel
can run; for CUDA tensors it launches the kernel or raises.  ``launches``
counts kernel launches, ``launchesWgmma`` those of the ``wgmma`` kernel.
"""

import ctypes

import torch

from puzzlelib_tpu_torch.ops.hopper import build


launches = 0
launchesWgmma = 0

_DTYPES = {torch.bfloat16: 1, torch.float16: 2}

# the kernels of ``pl_tapdot``'s path argument
_PATHS = {"wgmma": 0, "mma": 1}


def _check(xp, wk, bi, wp, kh, kw, c, co, nTiles):
    if xp.device != wk.device:
        raise ValueError("tapdot operands on %s and %s" % (xp.device, wk.device))

    if xp.dim() != 3 or xp.shape[2] != c or tuple(wk.shape) != (kh * kw, c, co):
        raise ValueError("tapdot takes xp (N, rows, %d) and wk (%d, %d, %d), got %s and %s" %
                         (c, kh * kw, c, co, tuple(xp.shape), tuple(wk.shape)))

    if xp.dtype != wk.dtype:
        raise TypeError("tapdot takes operands of one type, got %s and %s" % (xp.dtype, wk.dtype))

    if min(bi, wp, kh, kw, nTiles) < 1 or wp < kw:
        raise ValueError("tapdot takes positive bi, kh, kw, nTiles and a pitch wp >= kw, got bi %d, wp %d, kh %d, "
                         "kw %d, nTiles %d" % (bi, wp, kh, kw, nTiles))

    need = nTiles * bi * wp + (kh - 1) * wp + kw - 1
    if xp.shape[1] < need:
        raise ValueError("tapdot reads %d rows of xp for %d tiles of %d rows at pitch %d, got %d" %
                         (need, nTiles, bi, wp, xp.shape[1]))


def plain(xp, wk, bi, wp, kh, kw, c, co, nTiles):
    """The kh kw shifted products of ``tapdot`` in f32, rounded once to xp's
    type."""
    _check(xp, wk, bi, wp, kh, kw, c, co, nTiles)
    m = nTiles * bi * wp

    acc = None
    for r in range(kh):
        for s in range(kw):
            shift = r * wp + s
            part = torch.matmul(xp[:, shift:shift + m].float(), wk[r * kw + s].float())
            acc = part if acc is None else acc + part

    return acc.to(xp.dtype)


def _entry():
    fn = build.load("tapdot").pl_tapdot
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tapdot(xp, wk, bi, wp, kh, kw, c, co, nTiles):
    """xp (N, rows, C) in pitch layout, wk (kh kw, C, CO) -> (N, nTiles bi wp,
    CO) in xp's type, through probe kernel P1."""
    _check(xp, wk, bi, wp, kh, kw, c, co, nTiles)

    if xp.device.type == "cpu":
        return plain(xp, wk, bi, wp, kh, kw, c, co, nTiles)

    return _launch(xp, wk, bi, wp, kh, kw, c, co, nTiles, "wgmma")


def _launch(xp, wk, bi, wp, kh, kw, c, co, nTiles, path):
    """P1 on checked operands through the kernel of ``path``: ``"wgmma"``,
    the one ``tapdot`` takes, or ``"mma"``, the first ``mma.sync`` kernel,
    the yardstick (``chip_smoke.py`` and a card-only test reach it)."""
    if path not in _PATHS:
        raise ValueError("tap-dot kernel paths are %s, got %r" % (tuple(_PATHS), path))

    if xp.device.type != "cuda":
        raise ValueError("the tap-dot kernel runs on CUDA or CPU tensors, got %s" % xp.device)

    if xp.dtype not in _DTYPES:
        raise TypeError("the tap-dot kernel takes bf16 or f16 (Hopper's tensor cores have no f32 mode), got %s" %
                        xp.dtype)

    if c % 16 or co % 16:
        raise ValueError("the tap-dot kernel takes C and CO in multiples of 16, got %d and %d" % (c, co))

    xp, wk = xp.contiguous(), wk.contiguous()
    if xp.data_ptr() % 16 or wk.data_ptr() % 16:
        raise ValueError("the tap-dot kernel takes 16-byte aligned operands")

    n, rows = xp.shape[:2]
    m = nTiles * bi * wp
    out = torch.empty((n, m, co), dtype=xp.dtype, device=xp.device)
    if n == 0:
        return out

    with torch.cuda.device(xp.device):
        err = _entry()(xp.data_ptr(), wk.data_ptr(), out.data_ptr(), n, rows, m, c, co, wp, kh, kw,
                       _DTYPES[xp.dtype], _PATHS[path], torch.cuda.current_stream(xp.device).cuda_stream)

    if err != 0:
        raise RuntimeError("tap-dot kernel launch failed (%s) for xp %s, wk %s %s at pitch %d: cudaError %d" %
                           (path, tuple(xp.shape), tuple(wk.shape), xp.dtype, wp, err))

    global launches, launchesWgmma
    launches += 1
    if path == "wgmma":
        launchesWgmma += 1
    return out


def launchShape(wp, kh, kw):
    """(channel chunk, dynamic shared memory bytes) of a ``wgmma`` launch at
    pitch ``wp`` and a kh x kw filter on the current card, as the source
    computes them; (0, 0) where the slab does not fit and the launch
    refuses."""
    fn = build.load("tapdot").pl_tapdot_smem
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    chunk = ctypes.c_int(0)
    smem = fn(wp, kh, kw, ctypes.byref(chunk))
    return chunk.value, smem


def pickBi(oh, wp):
    """The probe's tile of output rows: the smallest bi >= 8 whose bi wp is a
    multiple of 8, grown while it stays below oh and bi wp below 400
    (``tools/tapdot_probe.py:127-137``)."""
    def aligned(bi):
        while (bi * wp) % 8 != 0:
            bi += 1
        return bi

    bi = aligned(8)
    while bi < oh and bi * wp < 400:
        grown = aligned(bi + 1)
        if grown > oh:
            break
        bi = grown

    return bi


def layout(x, w, pad=(1, 1), bi=None):
    """The operands of ``tapdot`` for the NCHW conv of x (N, C, H, W) with w
    (CO, C, kh, kw) at ``pad``: (xp, wk, geometry), xp the padded NHWC rows at
    pitch wp = OW + kw - 1, padded with zero rows to what the last tile
    reads, wk (kh kw, C, CO), and geometry the keyword arguments of
    ``tapdot`` with (oh, ow) for the crop."""
    n, c, h, wd = x.shape
    co, _, kh, kw = w.shape

    oh = h + 2 * pad[0] - kh + 1
    ow = wd + 2 * pad[1] - kw + 1
    wp = ow + kw - 1

    bi = pickBi(oh, wp) if bi is None else bi
    nTiles = -(-oh // bi)

    # NCHW -> pitch rows: xp[n, i wp + j, :] = xpad[n, i, j, :]
    xl = torch.nn.functional.pad(x.permute(0, 2, 3, 1), (0, 0, pad[1], wp - wd - pad[1], pad[0], pad[0]))
    xp = xl.reshape(n, xl.shape[1] * wp, c)

    fetchRows = -(-((bi + kh - 1) * wp + kw - 1) // 8) * 8
    rowsNeeded = (nTiles - 1) * bi * wp + fetchRows
    if xp.shape[1] < rowsNeeded:
        xp = torch.nn.functional.pad(xp, (0, 0, 0, rowsNeeded - xp.shape[1]))

    wk = w.permute(2, 3, 1, 0).reshape(kh * kw, c, co)
    geometry = dict(bi=bi, wp=wp, kh=kh, kw=kw, c=c, co=co, nTiles=nTiles)
    return xp.contiguous(), wk.contiguous(), geometry, (oh, ow)


def crop(out, geometry, oh, ow):
    """``tapdot``'s pitch rows (N, nTiles bi wp, CO) -> NCHW (N, CO, oh, ow)."""
    n, _, co = out.shape
    out = out.reshape(n, geometry["nTiles"] * geometry["bi"], geometry["wp"], co)[:, :oh, :ow, :]
    return out.permute(0, 3, 1, 2)


def conv2d(x, w, pad=(1, 1), bi=None):
    """The NCHW stride-1 conv of x (N, C, H, W) with w (CO, C, kh, kw) through
    the tap-dot kernel (the probe's entry): (N, CO, OH, OW) in x's type."""
    xp, wk, geometry, (oh, ow) = layout(x, w, pad, bi)
    return crop(tapdot(xp, wk, **geometry), geometry, oh, ow)
