"""BLAS dispatch (counterpart of ``puzzlelib_tpu/backend/blas.py``).

``mulMatrixOnMatrix`` sends a product on CUDA tensors to kernel K1 under the
reference's static conditions for its Pallas GEMM: both operands 2-D, no
transposes, alpha 1 and no beta accumulation, while ``Config.gemmAlgo`` is
"hopper"; under "auto" where the race of ``optimizeForShape`` recorded K1
for its shape and type (``ops.hopper.matmul._dispatch``), and for a shape
not raced where the reference's static prior takes its kernel (min(m, n,
k) >= 1024, n and k multiples of 128).  Every other product goes to ``ops.blas.gemm`` (``torch.matmul``),
the counterpart of the reference's XLA dot: so do the transposed products
and the ``beta`` accumulation of ``Linear``'s backward, as in the reference;
so does ``mulTensorBatch``, the grouped product (``torch.matmul``), which
the reference computes outside its Pallas kernel too.
A result with ``out`` is written into it in place, so it reaches gradient
buffers that are views of an optimizer's flat buffer.
"""

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.ops import blas as _ops
from puzzlelib_tpu_torch.ops import elementwise as _ew
from puzzlelib_tpu_torch.ops.hopper import matmul as _hopper


def kernelTakes(A, B, transpA=False, transpB=False, alpha=1.0, hasOut=False):
    """The static conditions under which a product may go to the GEMM kernel."""
    return A.dim() == 2 and B.dim() == 2 and not transpA and not transpB and not hasOut and alpha == 1.0


def useKernel(A, B):
    """True when ``Config.gemmAlgo`` sends A @ B (a product that
    ``kernelTakes``) to K1: the reference's ``_pallasGemmTiles(A, B) is not
    None``."""
    m, k = A.shape
    n = B.shape[1]
    key = _hopper.dispatchKey(m, n, k, A.dtype) if Config.gemmAlgo == "auto" else None
    prior = min(m, n, k) >= 1024 and n % 128 == 0 and k % 128 == 0
    return Config.route(Config.gemmAlgo, _hopper._dispatch, key, prior)


def _write(result, out):
    if out is None:
        return result

    out.copy_(result)
    return out


def mulMatrixOnMatrix(A, B, out=None, transpA=False, transpB=False, alpha=1.0, beta=0.0):
    hasOut = out is not None and beta != 0.0

    if A.is_cuda and kernelTakes(A, B, transpA, transpB, alpha, hasOut) and useKernel(A, B):
        return _write(_hopper.matmul(A.contiguous(), B.contiguous()), out)

    result = _ops.gemm(A, B, out if hasOut else None, alpha, beta, transpA=transpA, transpB=transpB)
    return _write(result, out)


def sumOnMatrix(A, out=None, cols=True, alpha=1.0, beta=0.0):
    if A.dim() != 2:
        raise ValueError("sumOnMatrix takes a matrix, got shape %s" % (tuple(A.shape), ))

    hasOut = out is not None and beta != 0.0
    result = _ops.matsum(A, 0 if cols else 1, out if hasOut else None, alpha, beta)

    return _write(result, out)


def mulTensorBatch(A, B, formatA="bgp", formatB="bgp", formatOut="bgp", transpA=False, transpB=False):
    """The product of each group's matrices (``ops.blas.gemmBatched``)."""
    return _ops.gemmBatched(A, B, formatA=formatA, formatB=formatB, formatOut=formatOut, transpA=transpA,
                            transpB=transpB)


def toVectorAddVector(y, x, alpha=1.0):
    """y += alpha * x, in place."""
    return _ew.toVectorAddVector_(y, x, alpha)
