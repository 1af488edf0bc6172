// Flash-attention backward for Hopper (sm_90a) on wgmma: dq, dk and dv of
// out = softmax(q k^T / sqrt(d)) v from the forward's out and per-row
// logsumexp, without the (seqQ, seqK) probability matrix ever reaching shared
// or device memory.
//
// Replaces the Pallas TPU kernels of puzzlelib_tpu/ops/pallas/flash.py
// (wrapper `_flashBackward`):
//   - K5a, `_dqKernel`: a (batch*heads, seqQ / bq) grid whose program holds
//     one query block and walks every key block, accumulating dq;
//   - K5b, `_dkvKernel`: a (batch*heads, seqK / bk) grid whose program holds
//     one key block and walks every query block, accumulating dk and dv.
// Both recompute, per (query, key) pair, in f32:
//   s = (q k^T) * scale, scale = 1 / sqrt(d), with the causal mask
//   qPos + (seqK - seqQ) >= kPos (bottom-right) setting masked scores to -1e30;
//   p = exp(s - lse), dP = dO v^T, dS = p * (dP - delta),
// with delta = rowsum(dO * out) computed by the caller from the forward's
// rounded out.  Then dq = dS k * scale, dk = dS^T q * scale, dv = p^T dO,
// P and dS rounded to the input type for the products that take them.
// A query row that sees no key (causal, seqQ > seqK) has lse = -1e30 (the
// forward's -1e30 + log(seqK) rounds to it in f32), so its p is 1 for every
// key, as in the TPU kernels: the gradient of an average over all keys that
// the forward's weights 1 / seqK are not; this is the reference's semantics,
// kept as it is.
//
// What bounds it on the H100: K5a does 3 products (S, dP, dS k: 6 * seqQ *
// seqK * d operations) and K5b 4 (S^T, dP^T, P^T dO, dS^T q: 8 * seqQ * seqK
// * d), 14 together against the 10 of a fused FlashAttention-2 backward,
// because the split recomputes S and dP in both kernels.  Each reads q, k, v,
// dO, lse and delta once and writes its outputs once: at the transformer
// slice's seq 80, d = 32 that is ~20 operations per byte and bound by memory
// and launch latency; at seq 2048, d = 64 some 500 per byte, above the ~295
// the tensor cores need.  In practice, as for K2 and K3, the delivery from
// L2 binds: every block reads all the walked tiles of its batch * head, so
// L2 hands out seq / 128 times the bytes above.
//
// The design.  The split is the TPU kernels' own and suits blocks that run in
// no order: K5a gives each block 128 query rows and writes their dq, K5b 128
// key rows and writes their dk and dv, so no block writes what another block
// writes: no atomics, and the result is deterministic.  A block is two
// warpgroups (256 threads); each owns 64 of the block's rows, wgmma's M, and
// both read the one walked tile of a step, which halves the bytes each
// product takes from L2 against a block of one warpgroup (that bound the
// first design: without its walked-tile loads it ran 2-3x faster):
//   - every tile in shared memory is in wgmma's core matrices without
//     swizzle (8 rows x 16 bytes, 128 contiguous bytes; the 8-row groups
//     16 d bytes apart, the 8-column groups 128 apart), so that one copy of
//     a tile is both the K-major operand of a product over its columns (LBO
//     128, SBO 16 d) and the MN-major B of a product over its rows (LBO 16 d,
//     SBO 128), and a thread's 16-byte cp.async lands at 16 times its index;
//   - K5b, per query tile of BQ rows (64; 32 at d 128): S^T = K Q^T and
//     dP^T = V dO^T as m64nBQk16 with both operands from shared memory,
//     K-major; P^T and dS^T in f32 on the accumulators, rounded and repacked
//     in registers as register-A fragments (the m64nN accumulator of a
//     thread is its A fragment of a product over those N columns, so no
//     value moves between threads); dV += P^T dO and dK += dS^T Q as
//     m64n{d}k16 with A from registers and B the dO or Q tile already in
//     shared memory, read MN-major (the transposed-B form bf16 and f16
//     allow).  dK and dV stay in registers (d / 2 f32 each a thread) until
//     the block's end.  At d 128 and BQ 64, S^T and dP^T beside them made
//     ptxas spill, hence BQ 32 there (m64n32k16);
//   - K5a, per key tile of 64 rows: S = Q K^T and dP = dO V^T as m64n64k16
//     from shared memory, dS as register-A, dQ += dS K as m64n{d}k16 with
//     the K tile read MN-major;
//   - the walked tiles (q, dO, lse and delta in K5b; k and v in K5a) go
//     through a three-stage ring by cp.async through L1 (16 bytes; 4 for lse
//     and delta), rows past the sequence zero-filled; a step's loads are issued once the
//     previous step's last products are done and land two steps later (two
//     stages measured 1.2x slower for K5a, no faster for K5b);
//   - a step issues its two score products as two commit groups and waits
//     for the first only, so P is computed while dP is still on the tensor
//     cores; the first product of every sum starts it with scale-d 0, so no
//     instruction outside wgmma defines a sum, and the warpgroup index is
//     broadcast from lane 0 (`__shfl_sync`) so that ptxas sees the address
//     arithmetic on it as uniform;
//   - masks only where a tile needs them: keys past seqK and queries past
//     seqQ get p = 0, the causal mask -1e30, in the tiles at the ragged ends
//     or on the diagonal; every other tile takes the unmasked path;
//   - with causal, K5a skips the key tiles wholly above the diagonal when
//     every row of its query tile sees key 0 (the forward's rule), and K5b
//     skips the query tiles wholly before its key tile when no query row is
//     fully masked (seqK >= seqQ): a fully masked row weighs every key 1.
// ptxas (CUDA 12.8, sm_90a; bf16 and f16 alike): K5b 156 / 186 / 206
// registers at d 32 / 64 / 128, K5a 128 / 157 / 226, no spill, one block an
// SM.  For K5b it reports a warpgroup.wait it injects into the loop (C7517):
// NVVM copies the last dK product's accumulator registers before it issues
// that product; issuing dK before dV, interleaving the two, fencing the
// sums after the commit and an opaque start flag all kept it, and none
// changed the time.  Shared memory: K5b 512 d + 3 (256 d + 512) bytes at d
// <= 64, 512 d + 3 (128 d + 256) at d 128; K5a 1280 d.
//
// Types: bf16 and f16, head dims 32, 64 and 128.  f32 is refused by the
// wrapper: Hopper's tensor cores have no f32 mode.
//
// Entries: pl_flash_backward_dq(...) and pl_flash_backward_dkv(...) launch on
// the caller's stream and return the cudaError_t of cudaGetLastError()
// (cudaErrorInvalidValue for a type or head dim they have no instance for).
// The caller allocates the outputs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int WG_ROWS = 64;             // a warpgroup's own rows (keys in K5b, queries in K5a): wgmma's M
constexpr int WGS = 2;                  // warpgroups a block, sharing each walked tile
constexpr int ROWS = WGS * WG_ROWS;     // the block's own rows
constexpr int THREADS = 128 * WGS;
constexpr int STAGES = 3;               // the ring of walked tiles: loads fly two tiles ahead
constexpr int BK = 64;                  // K5a: key rows of a walked tile
constexpr float MASKED = -1e30f;        // the TPU kernels' NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

// K5b: query rows of a walked tile; 32 at d 128, where S^T and dP^T of 64
// columns beside dK and dV made ptxas spill
template <int D>
__host__ __device__ constexpr int dkvBQ() { return D == 128 ? 32 : 64; }

// shared memory: the block's own two tiles and STAGES of the walked ones
// (K5b: q, dO, lse and delta; K5a: k and v)
template <int D, int BQ>
__host__ __device__ constexpr int dkvSmem() { return 2 * ROWS * D * 2 + STAGES * (2 * BQ * D * 2 + 2 * BQ * 4); }

template <int D>
__host__ __device__ constexpr int dqSmem() { return 2 * ROWS * D * 2 + STAGES * 2 * BK * D * 2; }

__device__ __forceinline__ unsigned smemAddr(const void* p)
{
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cpAsync16(void* smem, const void* gmem, bool valid)
{
    // src-size 0 fills the 16 bytes with zeros and reads nothing; through L1
    // (.ca), which measured faster than past it (.cg), as for K2
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smemAddr(smem)), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cpAsync4(void* smem, const void* gmem, bool valid)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smemAddr(smem)), "l"(gmem), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cpAsyncCommit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies but those of the last PENDING commit groups are in,
// and visible to the tensor cores once every thread is past the next barrier
template <int PENDING>
__device__ __forceinline__ void cpAsyncLanded()
{
    asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmmaFence()
{
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmmaCommit()
{
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmmaWait()
{
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ties the registers of a sum to this point of the program, so that the
// compiler neither reads them before a wait for the products nor moves their
// other uses across one
template <int N>
__device__ __forceinline__ void fenceSum(float (&acc)[N])
{
#pragma unroll
    for (int i = 0; i < N; ++i)
        asm volatile("" : "+f"(acc[i])::"memory");
}

// the same for register-A fragments, before the products that read them
template <int N>
__device__ __forceinline__ void fenceFragments(uint32_t (&a)[N][4])
{
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r)
            asm volatile("" : "+r"(a[i][r])::"memory");
}

// two floats as one register of the type's pair, lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi)
{
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi)
{
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + R) of a (rows, D) matrix into a shared tile of core
// matrices: 16-byte unit v (row 8 (v / 8 / (D / 8)) + v % 8, columns 8 ((v /
// 8) % (D / 8)) ..) at byte 16 v; rows past the end are zero
template <typename T, int D, int R>
__device__ __forceinline__ void loadTile(unsigned char* dst, const T* __restrict__ src, int row0, int rows, int tid)
{
    constexpr int G = D / 8;
    static_assert(R * G % THREADS == 0, "whole 16-byte units per thread");
#pragma unroll
    for (int i = 0; i < R * G / THREADS; ++i) {
        const int v = tid + i * THREADS;
        const int r = (v >> 3) / G * 8 + (v & 7), g = (v >> 3) % G;
        const bool ok = row0 + r < rows;
        cpAsync16(dst + 16 * v, ok ? src + (size_t)(row0 + r) * D + 8 * g : src, ok);
    }
}

// lse and delta of rows [row0, row0 + R) as [lse (R)][delta (R)] f32; rows
// past the end are zero
template <int R>
__device__ __forceinline__ void loadStats(float* dst, const float* __restrict__ lse, const float* __restrict__ delta,
                                          int row0, int rows, int tid)
{
#pragma unroll
    for (int v = tid; v < 2 * R; v += THREADS) {
        const int r = v % R;
        const bool ok = row0 + r < rows;
        cpAsync4(dst + v, ok ? (v < R ? lse : delta) + row0 + r : lse, ok);
    }
}

// a shared-memory matrix descriptor without swizzle
__device__ __forceinline__ uint64_t descriptor(const void* p, int lbo, int sbo)
{
    return (uint64_t)((smemAddr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// a tile as the K-major operand of a product over its columns: k-slice kc,
// columns 16 kc .. 16 kc + 15
template <int D>
__device__ __forceinline__ uint64_t kMajor(const unsigned char* tile, int kc)
{
    return descriptor(tile + 256 * kc, 128, 16 * D);
}

// a tile as the MN-major B operand of a product over its rows: k-slice c,
// rows 16 c .. 16 c + 15
template <int D>
__device__ __forceinline__ uint64_t mnMajor(const unsigned char* tile, int c)
{
    return descriptor(tile + 32 * D * c, 16 * D, 128);
}

#define PL_OUT8(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define PL_OUT16(d) PL_OUT8(d, 0), PL_OUT8(d, 8)
#define PL_OUT32(d) PL_OUT16(d), PL_OUT8(d, 16), PL_OUT8(d, 24)
#define PL_OUT64(d) PL_OUT32(d), PL_OUT8(d, 32), PL_OUT8(d, 40), PL_OUT8(d, 48), PL_OUT8(d, 56)

// d = A B + (accumulate ? d : 0), m64nNk16 in f32, N = 2 x the length of d:
// SS (the score products, N = 32 or 64) takes A and B from shared memory,
// both K-major; RS (the products into dK, dV, dQ, N = d) takes A from
// registers and B from shared memory, MN-major (transposed)
#define PL_WGMMA_SS_N32(TY) \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, " \
                 "%16, %17, p, 1, 1, 0, 0;\n}\n" \
                 : PL_OUT16(d) : "l"(da), "l"(db), "r"(accumulate))

#define PL_WGMMA_RS_N32(TY) \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, " \
                 "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n" \
                 : PL_OUT16(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate))

#define PL_WGMMA_SS_N64(TY) \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
                 "%32, %33, p, 1, 1, 0, 0;\n}\n" \
                 : PL_OUT32(d) : "l"(da), "l"(db), "r"(accumulate))

#define PL_WGMMA_RS_N64(TY) \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
                 "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
                 : PL_OUT32(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate))

#define PL_WGMMA_RS_N128(TY) \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
                 "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
                 : PL_OUT64(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate))

template <typename T>
__device__ __forceinline__ void wgmmaSS(float (&d)[16], uint64_t da, uint64_t db, int accumulate)
{
    if constexpr (std::is_same<T, __nv_bfloat16>::value) PL_WGMMA_SS_N32("bf16"); else PL_WGMMA_SS_N32("f16");
}

template <typename T>
__device__ __forceinline__ void wgmmaSS(float (&d)[32], uint64_t da, uint64_t db, int accumulate)
{
    if constexpr (std::is_same<T, __nv_bfloat16>::value) PL_WGMMA_SS_N64("bf16"); else PL_WGMMA_SS_N64("f16");
}

template <typename T>
__device__ __forceinline__ void wgmmaRS(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int accumulate)
{
    if constexpr (std::is_same<T, __nv_bfloat16>::value) PL_WGMMA_RS_N32("bf16"); else PL_WGMMA_RS_N32("f16");
}

template <typename T>
__device__ __forceinline__ void wgmmaRS(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate)
{
    if constexpr (std::is_same<T, __nv_bfloat16>::value) PL_WGMMA_RS_N64("bf16"); else PL_WGMMA_RS_N64("f16");
}

template <typename T>
__device__ __forceinline__ void wgmmaRS(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate)
{
    if constexpr (std::is_same<T, __nv_bfloat16>::value) PL_WGMMA_RS_N128("bf16"); else PL_WGMMA_RS_N128("f16");
}

// acc (64, N) = the 64 rows of tile `a` times the N rows of tile `b`
// transposed, over the D columns of both
template <typename T, int D, int N>
__device__ __forceinline__ void scores(float (&acc)[N / 2], const unsigned char* a, const unsigned char* b)
{
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
        wgmmaSS<T>(acc, kMajor<D>(a, kc), kMajor<D>(b, kc), kc > 0);
}

// acc (64, D) (+)= X (64, N) times tile (N, D), X as register-A fragments;
// `start` begins the sum
template <typename T, int D, int N>
__device__ __forceinline__ void accumulate(float (&acc)[D / 2], const uint32_t (&x)[N / 16][4],
                                           const unsigned char* tile, bool start)
{
#pragma unroll
    for (int c = 0; c < N / 16; ++c)
        wgmmaRS<T>(acc, x[c], mnMajor<D>(tile, c), !(start && c == 0));
}

// a (64, N) f32 accumulator rounded to T as the register-A fragments of a
// product over its N columns: a thread's accumulator values 8 c .. 8 c + 7
// (rows r, r + 8; columns 16 c + 2 (lane % 4) (+ 1) and 8 more) are its
// fragment of k-slice c
template <typename T, int N>
__device__ __forceinline__ void toOperand(uint32_t (&a)[N / 16][4], const float (&x)[N / 2])
{
#pragma unroll
    for (int c = 0; c < N / 16; ++c)
#pragma unroll
        for (int r = 0; r < 4; ++r)
            a[c][r] = pack2<T>(x[8 * c + 2 * r], x[8 * c + 2 * r + 1]);
}

// rows `row` and `row` + 8 of a (64, D) accumulator, times `mul`, to a (rows,
// D) matrix; rows past `rows` are not stored.  A thread holds columns 8 n +
// 2 (lane % 4) (+ 1) of them
template <typename T, int D>
__device__ __forceinline__ void store(T* out, const float (&acc)[D / 2], int row, int rows, float mul, int lane)
{
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r >= rows)
            continue;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
            *reinterpret_cast<uint32_t*>(out + (size_t)r * D + 8 * n + 2 * (lane & 3)) =
                pack2<T>(acc[4 * n + 2 * h] * mul, acc[4 * n + 2 * h + 1] * mul);
    }
}

// p = exp(s * scale - lse) as exp2, from the unscaled score; the masked score
// minus a blind row's lse is exactly 0
__device__ __forceinline__ float prob(float s, float scale, float lse)
{
    return exp2f((s * scale - lse) * LOG2E);
}

__device__ __forceinline__ float maskedProb(float lse)
{
    return exp2f((MASKED - lse) * LOG2E);
}

// K5b: dk and dv of ROWS key rows, walking the query tiles
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(THREADS)
flashBackwardDkv(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V, const T* __restrict__ dO,
                 const float* __restrict__ LSE, const float* __restrict__ DELTA, T* __restrict__ dK,
                 T* __restrict__ dV, int seqQ, int seqK, int causal, float scale)
{
    constexpr int KV = ROWS * D * 2, QT = BQ * D * 2, STAGE = 2 * QT + 2 * BQ * 4;
    static_assert(dkvSmem<D, BQ>() == 2 * KV + STAGES * STAGE, "the launch's shared memory");

    extern __shared__ __align__(128) unsigned char smem[];
    unsigned char* const ks = smem;
    unsigned char* const vs = smem + KV;
    unsigned char* const ring = smem + 2 * KV;   // per stage: q, dO, lse, delta

    const int tiles = (seqK + ROWS - 1) / ROWS;
    const int bh = blockIdx.x / tiles, k0 = (blockIdx.x % tiles) * ROWS;
    const int tid = threadIdx.x, lane = tid & 31;
    const int wg = __shfl_sync(0xFFFFFFFFu, tid >> 7, 0);   // uniform: ptxas keeps the products asynchronous
    const int offset = seqK - seqQ;

    const T* q = Q + (size_t)bh * seqQ * D;
    const T* dout = dO + (size_t)bh * seqQ * D;
    const float* lse = LSE + (size_t)bh * seqQ;
    const float* delta = DELTA + (size_t)bh * seqQ;

    const int nq = (seqQ + BQ - 1) / BQ;

    // with causal and no fully masked query row (offset >= 0), the query
    // tiles whose rows all lie before k0 - offset see none of these keys;
    // k0 - offset < seqQ, so at least one tile is left
    const int first = causal && offset >= 0 ? max(0, k0 - offset) / BQ : 0;

    auto load = [&](int j, int stage) {
        unsigned char* st = ring + stage * STAGE;
        loadTile<T, D, BQ>(st, q, j * BQ, seqQ, tid);
        loadTile<T, D, BQ>(st + QT, dout, j * BQ, seqQ, tid);
        loadStats<BQ>(reinterpret_cast<float*>(st + 2 * QT), lse, delta, j * BQ, seqQ, tid);
    };

    // the first STAGES - 1 query tiles, a commit group each, k and v with
    // the first
    loadTile<T, D, ROWS>(ks, K + (size_t)bh * seqK * D, k0, seqK, tid);
    loadTile<T, D, ROWS>(vs, V + (size_t)bh * seqK * D, k0, seqK, tid);
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
        if (first + i < nq)
            load(first + i, i);
        cpAsyncCommit();
    }

    // this thread's accumulator rows: keys k0 + row (+ 8); its columns of a
    // query tile: 8 n + col (+ 1).  Its warpgroup's rows of k and v
    const int row = WG_ROWS * wg + 16 * ((tid >> 5) & 3) + (lane >> 2), col = 2 * (lane & 3);
    const unsigned char* kw = ks + wg * (WG_ROWS * D * 2);
    const unsigned char* vw = vs + wg * (WG_ROWS * D * 2);

    float dk[D / 2], dv[D / 2];   // each set by its first product

    for (int j = first; j < nq; ++j) {
        const int i = j - first;
        const unsigned char* qs = ring + i % STAGES * STAGE;
        const unsigned char* dos = qs + QT;
        const float* ls = reinterpret_cast<const float*>(qs + 2 * QT);
        const float* ds = ls + BQ;

        cpAsyncLanded<STAGES - 2>();
        __syncthreads();   // tile j is in, for every thread and the tensor cores

        float s[BQ / 2], dp[BQ / 2];   // S^T and dP^T, each set by its first product
        wgmmaFence();
        scores<T, D, BQ>(s, kw, qs);
        wgmmaCommit();
        scores<T, D, BQ>(dp, vw, dos);
        wgmmaCommit();

        wgmmaWait<1>();    // S^T is done, and step j - 1's dV and dK products
        __syncthreads();   // ... in every warp: tile j - 1's stage is free
        if (j + STAGES - 1 < nq)
            load(j + STAGES - 1, (i + STAGES - 1) % STAGES);
        cpAsyncCommit();
        fenceSum(s);

        // P^T = exp(S^T scale - lse) over the tile's queries (the columns)
        const int q0 = j * BQ;
        const bool edge = k0 + ROWS > seqK || q0 + BQ > seqQ || (causal && q0 + offset < k0 + ROWS - 1);
        if (!edge) {
#pragma unroll
            for (int n = 0; n < BQ / 8; ++n) {
                const float2 l = *reinterpret_cast<const float2*>(ls + 8 * n + col);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    s[4 * n + e] = prob(s[4 * n + e], scale, e & 1 ? l.y : l.x);
            }
        } else {
            // keys past seqK and queries past seqQ get 0
#pragma unroll
            for (int n = 0; n < BQ / 8; ++n) {
                const float2 l = *reinterpret_cast<const float2*>(ls + 8 * n + col);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int query = q0 + 8 * n + col + (e & 1), key = k0 + row + 8 * (e >> 1);
                    const float lq = e & 1 ? l.y : l.x;
                    float p = 0.0f;
                    if (query < seqQ && key < seqK)
                        p = causal && query + offset < key ? maskedProb(lq) : prob(s[4 * n + e], scale, lq);
                    s[4 * n + e] = p;
                }
            }
        }

        // dS^T = P^T (dP^T - delta)
        wgmmaWait<0>();
        fenceSum(dp);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
            const float2 dl = *reinterpret_cast<const float2*>(ds + 8 * n + col);
#pragma unroll
            for (int e = 0; e < 4; ++e)
                dp[4 * n + e] = s[4 * n + e] * (dp[4 * n + e] - (e & 1 ? dl.y : dl.x));
        }

        // dV += P^T dO, dK += dS^T Q
        uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
        toOperand<T, BQ>(pa, s);
        toOperand<T, BQ>(dsa, dp);
        // the fragments and sums are written before the fence, not moved past it
        fenceFragments(pa);
        fenceFragments(dsa);
        fenceSum(dv);
        fenceSum(dk);
        wgmmaFence();
        accumulate<T, D, BQ>(dv, pa, dos, j == first);
        accumulate<T, D, BQ>(dk, dsa, qs, j == first);
        wgmmaCommit();
    }

    wgmmaWait<0>();
    fenceSum(dk);
    fenceSum(dv);
    store<T, D>(dK + (size_t)bh * seqK * D, dk, k0 + row, seqK, scale, lane);
    store<T, D>(dV + (size_t)bh * seqK * D, dv, k0 + row, seqK, 1.0f, lane);
}

// K5a: dq of ROWS query rows, walking the key tiles
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flashBackwardDq(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V, const T* __restrict__ dO,
                const float* __restrict__ LSE, const float* __restrict__ DELTA, T* __restrict__ dQ,
                int seqQ, int seqK, int causal, float scale)
{
    constexpr int QT = ROWS * D * 2, KT = BK * D * 2, STAGE = 2 * KT;
    static_assert(dqSmem<D>() == 2 * QT + STAGES * STAGE, "the launch's shared memory");

    extern __shared__ __align__(128) unsigned char smem[];
    unsigned char* const qs = smem;
    unsigned char* const dos = smem + QT;
    unsigned char* const ring = smem + 2 * QT;   // per stage: k, v

    const int tiles = (seqQ + ROWS - 1) / ROWS;
    const int bh = blockIdx.x / tiles, q0 = (int)(blockIdx.x % tiles) * ROWS;
    const int tid = threadIdx.x, lane = tid & 31;
    const int wg = __shfl_sync(0xFFFFFFFFu, tid >> 7, 0);   // uniform: ptxas keeps the products asynchronous
    const int offset = seqK - seqQ;

    const T* k = K + (size_t)bh * seqK * D;
    const T* v = V + (size_t)bh * seqK * D;

    int nk = (seqK + BK - 1) / BK;
    if (causal && q0 + offset >= 0) {
        // every row of the tile sees key 0, so the tiles past its last
        // visible key add exactly nothing
        const int lastKey = min(seqK - 1, min(q0 + ROWS - 1, seqQ - 1) + offset);
        nk = lastKey / BK + 1;
    }

    auto load = [&](int j, int stage) {
        unsigned char* st = ring + stage * STAGE;
        loadTile<T, D, BK>(st, k, j * BK, seqK, tid);
        loadTile<T, D, BK>(st + KT, v, j * BK, seqK, tid);
    };

    // the first STAGES - 1 key tiles, a commit group each, q and dO with the
    // first
    loadTile<T, D, ROWS>(qs, Q + (size_t)bh * seqQ * D, q0, seqQ, tid);
    loadTile<T, D, ROWS>(dos, dO + (size_t)bh * seqQ * D, q0, seqQ, tid);
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
        if (i < nk)
            load(i, i);
        cpAsyncCommit();
    }

    // this thread's accumulator rows: queries q0 + row (+ 8); its columns of
    // a key tile: 8 n + col (+ 1).  Rows past seqQ are zero in q and dO and
    // are not stored.  Its warpgroup's rows of q and dO
    const int row = WG_ROWS * wg + 16 * ((tid >> 5) & 3) + (lane >> 2), col = 2 * (lane & 3);
    const unsigned char* qw = qs + wg * (WG_ROWS * D * 2);
    const unsigned char* dow = dos + wg * (WG_ROWS * D * 2);
    float lse[2], delta[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = q0 + row + 8 * h;
        const bool ok = r < seqQ;
        lse[h] = ok ? LSE[(size_t)bh * seqQ + r] : 0.0f;
        delta[h] = ok ? DELTA[(size_t)bh * seqQ + r] : 0.0f;
    }

    float dq[D / 2];   // set by its first product

    for (int j = 0; j < nk; ++j) {
        const unsigned char* kts = ring + j % STAGES * STAGE;
        const unsigned char* vts = kts + KT;

        cpAsyncLanded<STAGES - 2>();
        __syncthreads();   // tile j is in, for every thread and the tensor cores

        float s[BK / 2], dp[BK / 2];   // S and dP, each set by its first product
        wgmmaFence();
        scores<T, D, BK>(s, qw, kts);
        wgmmaCommit();
        scores<T, D, BK>(dp, dow, vts);
        wgmmaCommit();

        wgmmaWait<1>();    // S is done, and step j - 1's dQ products
        __syncthreads();   // ... in every warp: tile j - 1's stage is free
        if (j + STAGES - 1 < nk)
            load(j + STAGES - 1, (j + STAGES - 1) % STAGES);
        cpAsyncCommit();
        fenceSum(s);

        // P = exp(S scale - lse) over the tile's keys (the columns)
        const int kt0 = j * BK;
        const bool edge = kt0 + BK > seqK || q0 + ROWS > seqQ || (causal && q0 + offset < kt0 + BK - 1);
        if (!edge) {
#pragma unroll
            for (int i = 0; i < BK / 2; ++i)
                s[i] = prob(s[i], scale, lse[(i >> 1) & 1]);
        } else {
            // keys past seqK get 0
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) {
                const int h = (i >> 1) & 1, key = kt0 + 8 * (i >> 2) + col + (i & 1);
                float p = 0.0f;
                if (key < seqK)
                    p = causal && q0 + row + 8 * h + offset < key ? maskedProb(lse[h]) : prob(s[i], scale, lse[h]);
                s[i] = p;
            }
        }

        // dS = P (dP - delta), then dQ += dS K
        wgmmaWait<0>();
        fenceSum(dp);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
            dp[i] = s[i] * (dp[i] - delta[(i >> 1) & 1]);

        uint32_t dsa[BK / 16][4];
        toOperand<T, BK>(dsa, dp);
        fenceFragments(dsa);
        fenceSum(dq);
        wgmmaFence();
        accumulate<T, D, BK>(dq, dsa, kts, j == 0);
        wgmmaCommit();
    }

    wgmmaWait<0>();
    fenceSum(dq);
    store<T, D>(dQ + (size_t)bh * seqQ * D, dq, q0 + row, seqQ, scale, lane);
}

template <typename Kernel>
cudaError_t allowSmem(Kernel kernel, int bytes, bool& sized)
{
    // once per instance: above 48 KB needs the opt-in
    if (sized)
        return cudaSuccess;

    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    sized = err == cudaSuccess;
    return err;
}

struct Args {
    const void *q, *k, *v, *dout;
    const float *lse, *delta;
    void *dq, *dk, *dv;
    int bh, seqQ, seqK, causal;
    cudaStream_t stream;
};

// one block per (batch * head, ROWS-row tile), the tiles of one batch * head
// side by side
cudaError_t gridOf(const Args& a, int seq, unsigned& blocks)
{
    const long long n = (long long)a.bh * ((seq + ROWS - 1) / ROWS);
    if (n > 0x7FFFFFFF)
        return cudaErrorInvalidValue;
    blocks = (unsigned)n;
    return cudaSuccess;
}

template <typename T, int D>
cudaError_t launchDq(const Args& a)
{
    constexpr int bytes = dqSmem<D>();
    static bool sized = false;
    unsigned blocks = 0;
    cudaError_t err = allowSmem(flashBackwardDq<T, D>, bytes, sized);
    if (err == cudaSuccess)
        err = gridOf(a, a.seqQ, blocks);
    if (err != cudaSuccess)
        return err;

    flashBackwardDq<T, D><<<blocks, THREADS, bytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dq), a.seqQ, a.seqK, a.causal,
        1.0f / sqrtf((float)D));
    return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launchDkv(const Args& a)
{
    constexpr int BQ = dkvBQ<D>(), bytes = dkvSmem<D, BQ>();
    static bool sized = false;
    unsigned blocks = 0;
    cudaError_t err = allowSmem(flashBackwardDkv<T, D, BQ>, bytes, sized);
    if (err == cudaSuccess)
        err = gridOf(a, a.seqK, blocks);
    if (err != cudaSuccess)
        return err;

    flashBackwardDkv<T, D, BQ><<<blocks, THREADS, bytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.seqQ,
        a.seqK, a.causal, 1.0f / sqrtf((float)D));
    return cudaGetLastError();
}

template <template <typename, int> class Launch, typename T>
cudaError_t launchDim(const Args& a, int d)
{
    switch (d) {
    case 32:  return Launch<T, 32>::run(a);
    case 64:  return Launch<T, 64>::run(a);
    case 128: return Launch<T, 128>::run(a);
    default:  return cudaErrorInvalidValue;
    }
}

template <typename T, int D>
struct Dq {
    static cudaError_t run(const Args& a) { return launchDq<T, D>(a); }
};

template <typename T, int D>
struct Dkv {
    static cudaError_t run(const Args& a) { return launchDkv<T, D>(a); }
};

template <template <typename, int> class Launch>
cudaError_t launchType(const Args& a, int d, int dtype)
{
    switch (dtype) {
    case 1:  return launchDim<Launch, __nv_bfloat16>(a, d);
    case 2:  return launchDim<Launch, __half>(a, d);
    default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 1 bf16, 2 f16 (the numbering of matmul.cu; 0, f32, has no instance).
// q, dout, dq: (bh, seqQ, d); k, v: (bh, seqK, d); lse, delta: (bh, seqQ) f32.
extern "C" int pl_flash_backward_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                                    const float* delta, void* dq, int bh, int seqQ, int seqK, int d, int dtype,
                                    int causal, void* stream)
{
    const Args a = {q, k, v, dout, lse, delta, dq, nullptr, nullptr, bh, seqQ, seqK, causal,
                    static_cast<cudaStream_t>(stream)};
    return launchType<Dq>(a, d, dtype);
}

// dk, dv: (bh, seqK, d)
extern "C" int pl_flash_backward_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                                     const float* delta, void* dk, void* dv, int bh, int seqQ, int seqK, int d,
                                     int dtype, int causal, void* stream)
{
    const Args a = {q, k, v, dout, lse, delta, nullptr, dk, dv, bh, seqQ, seqK, causal,
                    static_cast<cudaStream_t>(stream)};
    return launchType<Dkv>(a, d, dtype);
}
