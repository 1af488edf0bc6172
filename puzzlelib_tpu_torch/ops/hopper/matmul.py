"""Kernel K1: tiled GEMM for Hopper, hand-written in CUDA C++ (``csrc/matmul.cu``).

Replaces ``puzzlelib_tpu/ops/pallas/matmul.py`` ``_matmulKernel`` (wrappers
``matmul`` and ``matmulPadded``).  ``matmul(a, b)`` computes (M, K) @ (K, N)
with f32 accumulation and returns the input's type, for f32, bf16 and f16;
for two int8 matrices (K1-int8, the int8 serving engine's product) it
accumulates exactly in int32 and returns int32, as the reference does
(``matmul.py:54-56``).  Ragged M, N and K are masked inside the kernel, so
nothing is padded.  K1 is two kernels a type, chosen from the shape before
launch (``_route``): products that TMA can describe run on ``wgmma`` fed by
TMA (bf16 and f16 with K and N multiples of 8, int8 with K a multiple of 16,
both bases on 16 bytes), the rest (the transformer head's N = 2, ragged K or
N, conv1_1's K = 27 if it came unpadded) on the WMMA kernel.  bf16 and f16
take 128-row blocks for large products bound by their operations and
64-row blocks elsewhere; int8 takes 128-row blocks unless M <= 64.  f32 runs
as FFMA, in full f32, since Hopper's tensor cores have no f32 mode.  Where
the output tiles are too few to fill the card (the serving shapes, M = 32),
K is split into slices whose partial tiles (f32, or int32 for int8) a second
kernel sums in order; the wrapper allocates them.  The WMMA kernels' row
blocks lie on the grid's second axis, which holds 65535 blocks: a product of
more than 64 * 65535 = 4,194,240 rows runs there in chunks of that many
rows, one launch each (the wgmma kernels need none).  What bounds it and how
it is tiled is in the note at the top of ``csrc/matmul.cu``.

For 8-bit types ``wgmma`` reads both operands K-major, so K1-int8 on
``wgmma`` takes B as B^T, an (N, K) table: ``matmulNT(a, bt)`` computes (M,
K) @ (N, K)^T into int32, and the int8 engine lays its weight tables out
that way once, at build time.  ``matmul(a, b)`` with a row-major int8 (K, N)
``b`` keeps its contract: on the card it lays ``b`` out as B^T at each call
and launches the same kernel.  ``matmulNT`` on a shape the WMMA kernel takes
lays ``bt`` out as (K, N) at each call.

``plain`` and ``plainNT`` are the same functions in plain PyTorch.  The
wrappers take them for tensors on the CPU, where no kernel can run; for CUDA
tensors they launch the kernel or raise.  ``launches`` counts the float
launches (both kernels), ``launchesWgmma`` those of them on ``wgmma``,
``launchesInt8`` the int8 ones (both kernels) and ``launchesInt8Wgmma``
those of them on ``wgmma``, so a run can show that its products went
through the kernels.

``tuneDispatch`` races K1 against cuBLAS at one product's shape and type and
records the faster in ``_dispatch``, keyed by ``dispatchKey`` as the
reference keys its table (``matmul.py:170-171``): ``Config.gemmAlgo = "auto"``
reads it (``backend.blas``).  ``autotune`` times K1 alone at the path that
``_route`` picks, where the reference sweeps its Pallas tiles, which K1 has
no counterpart of: its path follows from the shape.

``matmulOp`` and ``matmulNTOp`` are ``matmul`` and ``matmulNT`` registered as
the custom operators ``puzzlelib::matmul`` and ``puzzlelib::matmul_nt``, with
shape functions.  The wrappers hand a fake tensor, which is what
``torch.export`` traces with, to them, so that an engine's graph records the
kernel instead of the ctypes call, which cannot run there; on real tensors
they launch directly, without the operator's dispatch.
"""

import ctypes

import torch
from torch._subclasses.fake_tensor import is_fake

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.backend.device import getDevice
from puzzlelib_tpu_torch.ops import blas as _blas
from puzzlelib_tpu_torch.ops.hopper import build
from puzzlelib_tpu_torch.tools import timing


launches = 0
launchesWgmma = 0
launchesInt8 = 0
launchesInt8Wgmma = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int8: 3}

# the bytes of one vector load, in elements of each type, and the tiled
# kernels' block rows (a grid's second axis holds at most 65535 blocks of them)
_VECTOR = {torch.float32: 8, torch.bfloat16: 8, torch.float16: 8, torch.int8: 16}
_BLOCK_ROWS, _MAX_GRID_Y = 64, 65535

# the kernel paths of pl_matmul (``Path`` in csrc/matmul.cu): the tiled
# kernels with element or 16-byte loads, and wgmma with 64- or 128-row blocks
_PATHS = {"tiled": 0, "tiled-vec": 1, "wgmma-64": 2, "wgmma-128": 3}

# the H100's operations per byte of device memory at which bf16 products
# turn from bytes-bound to operations-bound: 989 TFLOP/s over 3.35 TB/s
_RIDGE = 295


def _outType(dtype):
    return torch.int32 if dtype == torch.int8 else dtype


def plain(a, b):
    """(M, K) @ (K, N) in f32, returned in ``a``'s type; int8 operands give
    their exact int32 product.  Full f32 needs TF32 off, which
    ``Config.matmulPrecision = "highest"`` (the default) sets.

    The int8 product is taken in f64, where it is exact: every term is at
    most 127 * 128 and every partial sum an integer below 2^53 as long as K
    is below 5e11, in any order of summation.  Neither of the direct routes
    does: ``torch.matmul`` of two int8 tensors gives an int8 result that
    wraps around on the CPU, and has no integer kernel on the card."""
    if a.dtype == torch.int8:
        return torch.matmul(a.double(), b.double()).to(torch.int32)

    return torch.matmul(a.float(), b.float()).to(a.dtype)


def plainNT(a, bt):
    """int8 (M, K) @ (N, K)^T, the exact int32 product, as ``plain``."""
    return plain(a, bt.t())


def _entries():
    lib = build.load("matmul")

    lib.pl_matmul_splits.argtypes = [ctypes.c_int] * 6
    lib.pl_matmul_splits.restype = ctypes.c_int

    lib.pl_matmul.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.pl_matmul.restype = ctypes.c_int

    return lib.pl_matmul_splits, lib.pl_matmul


def _check(a, b):
    if a.device != b.device:
        raise ValueError("matmul operands on %s and %s" % (a.device, b.device))

    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError("matmul takes (M, K) @ (K, N), got %s @ %s" % (tuple(a.shape), tuple(b.shape)))

    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError("matmul takes two f32, bf16, f16 or int8 matrices of one type, got %s and %s" %
                        (a.dtype, b.dtype))


def _onCard(a, b, name):
    if a.device.type != "cuda":
        raise ValueError("%s runs on CUDA or CPU tensors, got %s" % (name, a.device))

    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("%s takes contiguous row-major operands" % name)


def _pathOf(a, b, n):
    """``_route``'s path for ``a`` (M, K) against a second operand ``b`` of
    N columns (or N rows, for B^T) on ``a``'s card."""
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    m, k = a.shape
    return _route(m, n, k, a.dtype, a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0, sms)


def _checkNT(a, bt):
    if a.device != bt.device:
        raise ValueError("matmulNT operands on %s and %s" % (a.device, bt.device))

    if a.dim() != 2 or bt.dim() != 2 or a.shape[1] != bt.shape[1]:
        raise ValueError("matmulNT takes (M, K) @ (N, K)^T, got %s @ %s^T" % (tuple(a.shape), tuple(bt.shape)))

    if a.dtype != torch.int8 or bt.dtype != torch.int8:
        raise TypeError("matmulNT takes two int8 matrices, got %s and %s" % (a.dtype, bt.dtype))


def matmul(a, b):
    """a (M, K) @ b (K, N) -> (M, N) in a's type (int32 for int8), through
    kernel K1."""
    if is_fake(a):
        return matmulOp(a, b)

    _check(a, b)

    if a.device.type == "cpu":
        return plain(a, b)

    _onCard(a, b, "matmul")

    n = b.shape[1]
    out = torch.empty((a.shape[0], n), dtype=_outType(a.dtype), device=a.device)

    path = _pathOf(a, b, n)
    if a.dtype == torch.int8 and path.startswith("wgmma"):
        # wgmma reads B^T (N, K): laid out here, at each call (an engine
        # holds its tables laid out and calls matmulNT)
        _launch(a, b.t().contiguous(), out, path)
    else:
        _launchRows(a, b, out, path)

    return out


def matmulNT(a, bt):
    """int8 a (M, K) @ bt (N, K)^T -> int32 (M, N), through kernel K1-int8:
    on ``wgmma`` where TMA can describe the operands, ``bt`` as it is; on the
    WMMA kernel otherwise, ``bt`` laid out as (K, N) at each call."""
    if is_fake(a):
        return matmulNTOp(a, bt)

    _checkNT(a, bt)

    if a.device.type == "cpu":
        return plainNT(a, bt)

    _onCard(a, bt, "matmulNT")

    n = bt.shape[0]
    out = torch.empty((a.shape[0], n), dtype=torch.int32, device=a.device)

    path = _pathOf(a, bt, n)
    if path.startswith("wgmma"):
        _launch(a, bt, out, path)
    else:
        _launchRows(a, bt.t().contiguous(), out, path)

    return out


def _route(m, n, k, dtype, aligned, sms):
    """The kernel path of an (m, k) @ (k, n) product of ``dtype`` on a card
    of ``sms`` SMs, chosen from the shape alone, never from a failure.
    Products that TMA can describe go to wgmma: bf16 and f16 with K and N
    multiples of 8, int8 with K a multiple of 16 (its rows of 16-byte
    multiples), both bases on 16 bytes (``aligned``), M, N and K above 0.

    bf16 and f16: two consumer warpgroups a block (128 rows) halve the
    traffic through L2 that binds an operations-bound product, but only one
    such block fits an SM: they take the products that are bound by their
    operations and whose 128-row tiles alone give two blocks an SM, so that
    split-K stays off.  The rest (the slices' products, bound by their
    bytes) take one warpgroup (64 rows), two blocks an SM.

    int8: 128-row blocks with all of N up to 256 columns, so that a tall
    conv product reads A once and shares each walked tile of B^T between
    two warpgroups; 64-row blocks of 128 columns where M <= 64 (the fc
    layers at batch 32, whose rows would leave a second warpgroup idle).

    Products that TMA cannot describe go to the tiled kernels, with 16-byte
    loads where K, N and the bases allow."""
    vec = aligned and k % _VECTOR[dtype] == 0 and n % _VECTOR[dtype] == 0
    if min(m, n, k) > 0 and dtype == torch.int8 and aligned and k % 16 == 0:
        return "wgmma-64" if m <= 64 else "wgmma-128"

    if vec and dtype in (torch.bfloat16, torch.float16) and min(m, n, k) > 0:
        operationsBound = m * n * k > _RIDGE * (m * k + k * n + m * n)   # 2 m n k FLOP against 2-byte elements
        tiles = -(-m // 128) * -(-n // 128)
        return "wgmma-128" if operationsBound and tiles >= 2 * sms else "wgmma-64"

    return "tiled-vec" if vec else "tiled"


def _launchRows(a, b, out, path):
    """K1 on a tiled path, whose row blocks sit on the grid's second axis:
    longer products run in chunks of rows, one launch each."""
    for row in range(0, a.shape[0], _BLOCK_ROWS * _MAX_GRID_Y):
        rows = slice(row, row + _BLOCK_ROWS * _MAX_GRID_Y)
        _launch(a[rows], b, out[rows], path)


def _launch(a, b, out, path):
    """One launch of K1 on ``path`` into ``out`` (M, N): ``b`` is the (K, N)
    matrix, or for int8 on a wgmma path the (N, K) table B^T.  The
    measurement of the WMMA kernel beside the new one names its path."""
    m, k = a.shape
    n = out.shape[1]

    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    splitsOf, launch = _entries()

    # K slices, each a partial tile (f32; int32 for int8) that a second kernel sums
    slices = splitsOf(m, n, k, _DTYPES[a.dtype], _PATHS[path], sms)
    partial = None
    if slices > 1:
        partial = torch.empty((slices, m, n), dtype=torch.int32 if a.dtype == torch.int8 else torch.float32,
                              device=a.device)

    with torch.cuda.device(a.device):
        err = launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), 0 if partial is None else partial.data_ptr(),
                     m, n, k, _DTYPES[a.dtype], _PATHS[path], slices,
                     torch.cuda.current_stream(a.device).cuda_stream)

    if err != 0:
        raise RuntimeError("matmul kernel launch failed for %s @ %s %s on path %s: cudaError %d" %
                           (tuple(a.shape), tuple(b.shape), a.dtype, path, err))

    global launches, launchesWgmma, launchesInt8, launchesInt8Wgmma
    if a.dtype == torch.int8:
        launchesInt8 += 1
        if path.startswith("wgmma"):
            launchesInt8Wgmma += 1
    else:
        launches += 1
        if path.startswith("wgmma"):
            launchesWgmma += 1


# -- the measured dispatch of Config.gemmAlgo = "auto" ------------------------------

# dispatchKey -> "hopper" where K1 measured strictly faster than cuBLAS at the
# product's shape and type, "torch" where it did not; K1's seconds there
# (``_tunedSecs``, as the reference keeps them) and both times in ms
# (``_raceMs``: K1's, cuBLAS's)
_dispatch = {}
_tunedSecs = {}
_raceMs = {}

_RACED = (torch.float32, torch.bfloat16, torch.float16)

# the reference names a key's type as numpy does (bf16 is ml_dtypes' "<V2")
_NUMPY_STR = {torch.float32: "<f4", torch.float16: "<f2", torch.bfloat16: "<V2", torch.int8: "|i1"}


def dispatchKey(m, n, k, dtype):
    return (m, n, k, _NUMPY_STR.get(dtype, str(dtype)))


def _raceOperands(m, n, k, dtype, device):
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((m, k), generator=gen, device=device).to(dtype)
    b = (torch.randn((k, n), generator=gen, device=device) / k ** 0.5).to(dtype)
    return a, b


def autotune(m, n, k, dtype=torch.float32, iters=10):
    """K1's path at (m, n, k) (``_route``'s), its seconds there recorded in
    ``_tunedSecs``; None on the CPU, where no kernel runs."""
    device = getDevice()
    if not timing.raceable(device):
        return None

    a, b = _raceOperands(m, n, k, dtype, device)
    _tunedSecs[dispatchKey(m, n, k, dtype)] = timing.deviceMs(lambda: matmul(a, b), iters) / 1e3
    return _pathOf(a, b, n)


def tuneDispatch(m, n, k, dtype=torch.float32, iters=10, turns=3):
    """Race K1 against cuBLAS (``ops.blas.gemm``) on the same (m, k) @ (k,
    n) operands, in ``turns`` alternating turns of ``iters`` calls, and
    record "hopper" only where K1 is strictly faster, else "torch"
    (``matmul.py:200``).  Returns the choice, the recorded one for a key
    already measured; None on the CPU and for int8, whose products have no
    dispatch."""
    key = dispatchKey(m, n, k, dtype)
    if key in _dispatch:
        return _dispatch[key]

    device = getDevice()
    if dtype not in _RACED or not timing.raceable(device):
        return None

    a, b = _raceOperands(m, n, k, dtype, device)
    times = timing.race({"hopper": lambda: matmul(a, b), "torch": lambda: _blas.gemm(a, b, None, 1.0, 0.0)},
                        iters, turns)

    _tunedSecs[key] = times["hopper"] / 1e3
    _raceMs[key] = (times["hopper"], times["torch"])
    Config.recordChoice(_dispatch, key, "hopper" if timing.handWins(times["hopper"], times["torch"], 1.0) else "torch")
    return _dispatch[key]


@torch.library.custom_op("puzzlelib::matmul", mutates_args=())
def matmulOp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return matmul(a, b)


@matmulOp.register_fake
def _matmulShape(a, b):
    _check(a, b)
    return a.new_empty((a.shape[0], b.shape[1]), dtype=_outType(a.dtype))


@torch.library.custom_op("puzzlelib::matmul_nt", mutates_args=())
def matmulNTOp(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    return matmulNT(a, bt)


@matmulNTOp.register_fake
def _matmulNTShape(a, bt):
    _checkNT(a, bt)
    return a.new_empty((a.shape[0], bt.shape[0]), dtype=torch.int32)
