// The kernel paths of K1 and K4 as their Python wrappers choose them
// (ops/hopper/matmul.py _route, ops/hopper/flash.py blockRows), for the
// engine driver's C++ registrations of puzzlelib::matmul, matmul_nt and
// flash.  No torch dependency, so that a CPU test can hold these rules
// against the Python ones through a small shared library.
#pragma once

namespace routes {

// the element types of pl_matmul (csrc/matmul.cu)
enum DType { F32 = 0, BF16 = 1, F16 = 2, INT8 = 3 };

// the paths of pl_matmul (Path in csrc/matmul.cu)
enum Path { TILED = 0, TILED_VEC = 1, WGMMA_64 = 2, WGMMA_128 = 3 };

// the bytes of one vector load, in elements of each type
constexpr int VECTOR[4] = {8, 8, 8, 16};

// the tiled kernels' block rows; a grid's second axis holds 65535 blocks
constexpr long long BLOCK_ROWS = 64, MAX_GRID_Y = 65535;

// the H100's operations per byte at which bf16 products turn from
// bytes-bound to operations-bound: 989 TFLOP/s over 3.35 TB/s
constexpr long long RIDGE = 295;

inline long long ceilDiv(long long a, long long b) { return (a + b - 1) / b; }

// the path of an (m, k) @ (k, n) product of dtype on a card of sms SMs,
// with both bases on 16 bytes (aligned); see matmul._route
inline int matmulRoute(long long m, long long n, long long k, int dtype, bool aligned, int sms)
{
    const bool positive = m > 0 && n > 0 && k > 0;
    const bool vec = aligned && k % VECTOR[dtype] == 0 && n % VECTOR[dtype] == 0;

    if (positive && dtype == INT8 && aligned && k % 16 == 0)
        return m <= 64 ? WGMMA_64 : WGMMA_128;

    if (vec && (dtype == BF16 || dtype == F16) && positive) {
        // 2 m n k FLOP against 2-byte elements; exact in 128 bits, as Python's ints are
        const __int128 ops = (__int128)m * n * k;
        const __int128 bytes = (__int128)RIDGE * (m * k + k * n + m * n);
        const bool operationsBound = ops > bytes;
        const long long tiles = ceilDiv(m, 128) * ceilDiv(n, 128);
        return operationsBound && tiles >= 2LL * sms ? WGMMA_128 : WGMMA_64;
    }

    return vec ? TILED_VEC : TILED;
}

// query rows a block of K4's wgmma kernel owns; see flash.blockRows
inline int flashBlockRows(long long seqQ, long long bh, long long d, int sms)
{
    if (d != 64 && bh * ceilDiv(seqQ, 128) >= sms)
        return 128;
    return 64;
}

}  // namespace routes
