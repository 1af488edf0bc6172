"""GEMM-family primitives (counterpart of ``puzzlelib_tpu/ops/blas.py``): the
product, the grouped (batched) product, the sum along an axis and the
broadcast add of a vector.

Every product accumulates and scales in f32 and returns the input's type, as
the reference's ``preferred_element_type=float32`` contractions do.
"""

import torch


def gemm(A, B, C, alpha, beta, transpA=False, transpB=False):
    """alpha * op(A) @ op(B) (+ beta * C when C is given), in A's type.  The
    plain product runs in A's type, where cuBLAS accumulates bf16 and f16 in
    f32 (``backend.device.ensureInit`` keeps it from reducing in less)."""
    a = A.t() if transpA else A
    b = B.t() if transpB else B

    if alpha == 1.0 and C is None:
        return torch.matmul(a, b)

    out = torch.matmul(a.float(), b.float()) * alpha

    if C is not None:
        out = out + beta * C.float()

    return out.to(A.dtype)


def _groupMajor(T, fmt):
    """T in (groups, rows, cols) order: "gbp" is so already, "bgp" (rows,
    groups, cols) is swapped (a view either way)."""
    return T if fmt == "gbp" else T.transpose(0, 1)


def gemmBatched(A, B, formatA="bgp", formatB="bgp", formatOut="bgp", transpA=False, transpB=False):
    """op(A_g) @ op(B_g) for each group g, in A's type, laid out as
    ``formatOut``.  Each operand is "gbp" (groups, rows, cols) or "bgp"
    (rows, groups, cols); a group axis of 1 is broadcast over the other
    operand's groups.  The reference's ``lax.dot_general`` with an f32
    accumulator is no Pallas kernel, so this is ``torch.matmul``, which
    accumulates bf16 and f16 in f32 too."""
    a, b = _groupMajor(A, formatA), _groupMajor(B, formatB)
    a = a.transpose(1, 2) if transpA else a
    b = b.transpose(1, 2) if transpB else b
    return _groupMajor(torch.matmul(a, b).to(A.dtype), formatOut)


def matsum(A, axis, out, alpha, beta):
    """alpha * sum of A along ``axis`` (+ beta * out when out is given)."""
    s = A.float().sum(dim=axis) * alpha

    if out is not None:
        s = s + beta * out.float()

    return s.to(A.dtype)


def addVecToMat(v, m, axis, out=None):
    """m + v broadcast along ``axis`` (axis=1: v indexed by column; axis=0: by
    row), into ``out`` when given; ``out`` may be ``m`` itself."""
    if axis == 1:
        shape = (1, ) * (m.dim() - 1) + (v.numel(), )
    else:
        shape = (v.numel(), ) + (1, ) * (m.dim() - 1)

    return torch.add(m, v.reshape(shape).to(m.dtype), out=out)
