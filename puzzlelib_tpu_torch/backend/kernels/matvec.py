"""Mat-vec dispatch (counterpart of ``puzzlelib_tpu/backend/kernels/matvec.py``)."""

from puzzlelib_tpu_torch.ops import blas as _blas


def addVecToMat(vec, mat, axis=0, out=None):
    """mat + vec broadcast along ``axis``; into ``out`` when given, which may
    be ``mat`` itself (the add then runs in place)."""
    return _blas.addVecToMat(vec, mat, axis, out=out)
