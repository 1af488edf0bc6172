// Flash-attention backward for Hopper (sm_90a): dq, dk and dv of
// out = softmax(q k^T / sqrt(d)) v from the forward's out and per-row
// logsumexp, without the (seqQ, seqK) probability matrix ever reaching device
// memory.
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
// rounded out.  Then dq = dS k * scale, dk = dS^T q * scale, dv = p^T dO.
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
// the tensor cores need.
//
// The design.  The split is the TPU kernels' own and suits blocks that run in
// no order: K5a gives each block one 64-row query tile and writes dq, K5b one
// 64-row key tile and writes dk and dv, so no block writes what another block
// writes: no atomics, and the result is deterministic.  Like the forward
// (csrc/flash.cu):
//   - 4 warps of 16 rows each (query rows in K5a, key rows in K5b), on
//     mma.sync m16n8k16 with bf16 or f16 inputs and f32 accumulators;
//   - the tiles that are walked (K and V in K5a; q, dO, lse and delta in
//     K5b) are double-buffered in shared memory with cp.async, so the next
//     tile lands while this one is used; the block's own tiles stay in shared
//     memory and their fragments are read there by ldmatrix at each use,
//     which keeps the registers for the f32 accumulators (K5b holds dk and dv,
//     two (16, d) accumulators per warp: 128 registers a thread at d = 128);
//   - rows past the sequence are zero-filled (cp.async src-size 0); keys past
//     seqK get p = 0 (scored -inf in K5a, set in K5b), and K5b's query
//     columns past seqQ get p = 0 explicitly, since their lse and delta are
//     not read;
//   - the S accumulator fragments are the A fragments of the next product
//     (dS k in K5a; P^T dO and dS^T q in K5b), rounded in place to the input
//     type; the B operands that must be transposed (k in dS k, dO in P^T dO,
//     q in dS^T q) come through ldmatrix.trans;
//   - in K5b dP^T is computed one 8-column n-tile at a time and folded into
//     S^T at once, so no dP array is live beside the two accumulators;
//   - with causal, K5a skips the key tiles wholly above the diagonal when
//     every row of its query tile sees key 0 (the forward's rule), and K5b
//     skips the query tiles wholly before its key tile when no query row is
//     fully masked (seqK >= seqQ): a fully masked row weighs every key 1.
// wgmma, TMA and warp specialisation are the later steps.
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

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 128;
constexpr float MASKED = -1e30f;              // the TPU kernels' NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int pitch() { return D + 8; }       // 16 bytes of padding: ldmatrix rows hit distinct banks

// six 64-row tiles: the block's two and two stages of the two it walks; K5b
// adds two stages of the query tile's lse and delta
template <typename T, int D>
constexpr int tileBytes() { return 6 * 64 * pitch<D>() * (int)sizeof(T); }

__device__ __forceinline__ void cpAsync16(void* smem, const void* gmem, bool valid)
{
    // src-size 0 fills the 16 bytes with zeros and reads nothing
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cpAsyncCommit()
{
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cpAsyncWaitAll()
{
    asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrixX4(uint32_t (&r)[4], const void* smem)
{
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrixX4Trans(uint32_t (&r)[4], const void* smem)
{
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c += a (16x16, row) * b (16x8, col), f32 accumulators
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1);

template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1)
{
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma<__half>(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1)
{
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// rows [row0, row0 + 64) of a (rows, D) matrix into a pitched shared tile;
// rows past the end are zero
template <typename T, int D>
__device__ __forceinline__ void loadTile(T* dst, const T* __restrict__ src, int row0, int rows, int tid)
{
    constexpr int VECS = D / 8;   // 16-byte vectors per row
#pragma unroll
    for (int v = tid; v < 64 * VECS; v += THREADS) {
        const int r = v / VECS, c = (v % VECS) * 8;
        const bool ok = row0 + r < rows;
        cpAsync16(dst + r * pitch<D>() + c, ok ? src + (size_t)(row0 + r) * D + c : src, ok);
    }
}

// the A fragment (16x16, row-major) of rows [row0, row0 + 16) and columns
// [16 c, 16 c + 16) of a pitched tile
template <typename T, int D>
__device__ __forceinline__ void fragA(uint32_t (&a)[4], const T* tile, int row0, int c, int lane)
{
    ldmatrixX4(a, tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch<D>() + c * 16 + (lane >> 4) * 8);
}

// B fragments of a product with a tile's rows as the n index: rows
// [8 n, 8 n + 8) and columns [32 cc, 32 cc + 32), two k16 chunks: b[0], b[1]
// for chunk 2 cc, b[2], b[3] for chunk 2 cc + 1
template <typename T, int D>
__device__ __forceinline__ void fragB(uint32_t (&b)[4], const T* tile, int n, int cc, int lane)
{
    ldmatrixX4(b, tile + (n * 8 + (lane & 7)) * pitch<D>() + cc * 32 + (lane >> 3) * 8);
}

// B fragments of a product with a tile's rows as the k index (transposed):
// rows [16 c, 16 c + 16) and columns of n-tiles t (b[0], b[1]) and t + 1
// (b[2], b[3])
template <typename T, int D>
__device__ __forceinline__ void fragBTrans(uint32_t (&b)[4], const T* tile, int c, int t, int lane)
{
    ldmatrixX4Trans(b, tile + (c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch<D>() + t * 8 + (lane >> 4) * 8);
}

// acc (16, D) += X (16, 64) * tile (64, D), X the warp's (16, 64) f32
// accumulator fragments, rounded to T as the A operand
template <typename T, int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4], const float (&x)[8][4], const T* tile, int lane)
{
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const uint32_t a[4] = {pack2<T>(x[2 * c][0], x[2 * c][1]), pack2<T>(x[2 * c][2], x[2 * c][3]),
                               pack2<T>(x[2 * c + 1][0], x[2 * c + 1][1]),
                               pack2<T>(x[2 * c + 1][2], x[2 * c + 1][3])};
#pragma unroll
        for (int t = 0; t < D / 8; t += 2) {
            uint32_t b[4];
            fragBTrans<T, D>(b, tile, c, t, lane);
            mma<T>(acc[t], a, b[0], b[1]);
            mma<T>(acc[t + 1], a, b[2], b[3]);
        }
    }
}

// s (16, 64) = A rows [row0, row0 + 16) of `rowsTile` times the 64 rows of
// `colsTile` transposed, over the D columns of both
template <typename T, int D>
__device__ __forceinline__ void scores(float (&s)[8][4], const T* rowsTile, int row0, const T* colsTile, int lane)
{
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            s[n][e] = 0.0f;

#pragma unroll
    for (int cc = 0; cc < D / 32; ++cc) {
        uint32_t a0[4], a1[4];
        fragA<T, D>(a0, rowsTile, row0, 2 * cc, lane);
        fragA<T, D>(a1, rowsTile, row0, 2 * cc + 1, lane);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            uint32_t b[4];
            fragB<T, D>(b, colsTile, n, cc, lane);
            mma<T>(s[n], a0, b[0], b[1]);
            mma<T>(s[n], a1, b[2], b[3]);
        }
    }
}

// rows [row0, row0 + 16) of the warp's (16, D) accumulator, times `mul`, to
// a (rows, D) matrix; rows past `rows` are not stored
template <typename T, int D>
__device__ __forceinline__ void store(T* out, const float (&acc)[D / 8][4], int row0, int rows, float mul, int lane)
{
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = row0 + (lane >> 2) + 8 * i;
        if (r >= rows)
            continue;
#pragma unroll
        for (int t = 0; t < D / 8; ++t)
            *reinterpret_cast<uint32_t*>(out + (size_t)r * D + t * 8 + (lane & 3) * 2) =
                pack2<T>(acc[t][2 * i] * mul, acc[t][2 * i + 1] * mul);
    }
}

// K5a: dq of one 64-row query tile, walking the key tiles
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flashBackwardDq(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V, const T* __restrict__ dO,
                const float* __restrict__ LSE, const float* __restrict__ DELTA, T* __restrict__ dQ,
                int seqQ, int seqK, int causal, float scale)
{
    constexpr int P = pitch<D>();

    extern __shared__ __align__(128) unsigned char smem[];
    T* Qs = reinterpret_cast<T*>(smem);
    T* dOs = Qs + BQ * P;
    T* Ks = dOs + BQ * P;         // two stages each
    T* Vs = Ks + 2 * BK * P;

    const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int offset = seqK - seqQ;

    const T* k = K + (size_t)bh * seqK * D;
    const T* v = V + (size_t)bh * seqK * D;

    int nk = (seqK + BK - 1) / BK;
    if (causal && q0 + offset >= 0) {
        // every row of the tile sees key 0, so the tiles past its last
        // visible key add exactly nothing
        const int lastKey = min(seqK - 1, min(q0 + BQ - 1, seqQ - 1) + offset);
        nk = lastKey / BK + 1;
    }

    loadTile<T, D>(Qs, Q + (size_t)bh * seqQ * D, q0, seqQ, tid);
    loadTile<T, D>(dOs, dO + (size_t)bh * seqQ * D, q0, seqQ, tid);
    loadTile<T, D>(Ks, k, 0, seqK, tid);
    loadTile<T, D>(Vs, v, 0, seqK, tid);
    cpAsyncCommit();

    // this thread's rows of the warp's 16: r and r + 8; rows past seqQ are
    // zero in q and dO, so their dS is 0 whatever lse and delta they get
    const int rowA = q0 + warp * 16 + (lane >> 2);
    const int rows[2] = {rowA, rowA + 8};
    float lse[2], delta[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const bool ok = rows[i] < seqQ;
        lse[i] = ok ? LSE[(size_t)bh * seqQ + rows[i]] : 0.0f;
        delta[i] = ok ? DELTA[(size_t)bh * seqQ + rows[i]] : 0.0f;
    }

    float acc[D / 8][4];
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            acc[t][e] = 0.0f;

    for (int j = 0; j < nk; ++j) {
        cpAsyncWaitAll();   // tile j (and q, dO) has landed
        __syncthreads();    // ... for every thread, and tile j - 1 is consumed

        if (j + 1 < nk) {
            loadTile<T, D>(Ks + ((j + 1) & 1) * BK * P, k, (j + 1) * BK, seqK, tid);
            loadTile<T, D>(Vs + ((j + 1) & 1) * BK * P, v, (j + 1) * BK, seqK, tid);
        }
        cpAsyncCommit();

        const T* ks = Ks + (j & 1) * BK * P;
        const T* vs = Vs + (j & 1) * BK * P;

        // S = q k^T and dP = dO v^T for the warp's 16 rows and the tile's 64 keys
        float s[8][4], dp[8][4];
        scores<T, D>(s, Qs, warp * 16, ks, lane);
        scores<T, D>(dp, dOs, warp * 16, vs, lane);

        // dS = P * (dP - delta), P = exp(s * scale - lse) under the masks
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = j * BK + n * 8 + (lane & 3) * 2 + (e & 1), i = e >> 1;
                float p = 0.0f;
                if (key < seqK) {
                    const float x = causal && rows[i] + offset < key ? MASKED : s[n][e] * scale;
                    p = exp2f((x - lse[i]) * LOG2E);
                }
                s[n][e] = p * (dp[n][e] - delta[i]);
            }

        // dq += dS k
        accumulate<T, D>(acc, s, ks, lane);
    }

    cpAsyncWaitAll();
    store<T, D>(dQ + (size_t)bh * seqQ * D, acc, q0 + warp * 16, seqQ, scale, lane);
}

// K5b: dk and dv of one 64-row key tile, walking the query tiles
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flashBackwardDkv(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V, const T* __restrict__ dO,
                 const float* __restrict__ LSE, const float* __restrict__ DELTA, T* __restrict__ dK,
                 T* __restrict__ dV, int seqQ, int seqK, int causal, float scale)
{
    constexpr int P = pitch<D>();

    extern __shared__ __align__(128) unsigned char smem[];
    T* Ks = reinterpret_cast<T*>(smem);
    T* Vs = Ks + BK * P;
    T* Qs = Vs + BK * P;          // two stages each
    T* dOs = Qs + 2 * BQ * P;
    float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ * P);   // two stages of 64 each
    float* Ds = Ls + 2 * BQ;

    const int bh = blockIdx.x, k0 = blockIdx.y * BK;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int offset = seqK - seqQ;

    const T* q = Q + (size_t)bh * seqQ * D;
    const T* dout = dO + (size_t)bh * seqQ * D;
    const float* lseRow = LSE + (size_t)bh * seqQ;
    const float* deltaRow = DELTA + (size_t)bh * seqQ;

    const int nq = (seqQ + BQ - 1) / BQ;

    // with causal and no fully masked query row (offset >= 0), the query
    // tiles whose rows all lie before k0 - offset see none of these keys
    const int first = causal && offset >= 0 ? max(0, k0 - offset) / BQ : 0;

    auto loadStats = [&](int stage, int j) {
        // plain loads: visible to every thread after the next __syncthreads
        if (tid < BQ) {
            const int r = j * BQ + tid;
            Ls[stage * BQ + tid] = r < seqQ ? lseRow[r] : 0.0f;
            Ds[stage * BQ + tid] = r < seqQ ? deltaRow[r] : 0.0f;
        }
    };

    loadTile<T, D>(Ks, K + (size_t)bh * seqK * D, k0, seqK, tid);
    loadTile<T, D>(Vs, V + (size_t)bh * seqK * D, k0, seqK, tid);
    if (first < nq) {
        loadTile<T, D>(Qs, q, first * BQ, seqQ, tid);
        loadTile<T, D>(dOs, dout, first * BQ, seqQ, tid);
        loadStats(0, first);
    }
    cpAsyncCommit();

    const int keyA = k0 + warp * 16 + (lane >> 2);
    const int keys[2] = {keyA, keyA + 8};

    float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            dk[t][e] = dv[t][e] = 0.0f;

    for (int j = first; j < nq; ++j) {
        const int stage = (j - first) & 1;

        cpAsyncWaitAll();   // tile j (and k, v) has landed
        __syncthreads();    // ... for every thread, and tile j - 1 is consumed

        if (j + 1 < nq) {
            loadTile<T, D>(Qs + (stage ^ 1) * BQ * P, q, (j + 1) * BQ, seqQ, tid);
            loadTile<T, D>(dOs + (stage ^ 1) * BQ * P, dout, (j + 1) * BQ, seqQ, tid);
            loadStats(stage ^ 1, j + 1);
        }
        cpAsyncCommit();

        const T* qs = Qs + stage * BQ * P;
        const T* dos = dOs + stage * BQ * P;
        const float* ls = Ls + stage * BQ;
        const float* ds = Ds + stage * BQ;

        // S^T = k q^T for the warp's 16 keys and the tile's 64 queries, and
        // P^T = exp(S^T * scale - lse) under the masks; keys past seqK and
        // queries past seqQ get 0
        float s[8][4];
        scores<T, D>(s, Ks, warp * 16, qs, lane);

#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = n * 8 + (lane & 3) * 2 + (e & 1), query = j * BQ + col, key = keys[e >> 1];
                float p = 0.0f;
                if (query < seqQ && key < seqK) {
                    const float x = causal && query + offset < key ? MASKED : s[n][e] * scale;
                    p = exp2f((x - ls[col]) * LOG2E);
                }
                s[n][e] = p;
            }

        // dv += P^T dO
        accumulate<T, D>(dv, s, dos, lane);

        // dS^T = P^T * (dP^T - delta), dP^T = v dO^T one n-tile at a time
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            float dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int cc = 0; cc < D / 32; ++cc) {
                uint32_t a0[4], a1[4], b[4];
                fragA<T, D>(a0, Vs, warp * 16, 2 * cc, lane);
                fragA<T, D>(a1, Vs, warp * 16, 2 * cc + 1, lane);
                fragB<T, D>(b, dos, n, cc, lane);
                mma<T>(dp, a0, b[0], b[1]);
                mma<T>(dp, a1, b[2], b[3]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e)
                s[n][e] *= dp[e] - ds[n * 8 + (lane & 3) * 2 + (e & 1)];
        }

        // dk += dS^T q
        accumulate<T, D>(dk, s, qs, lane);
    }

    cpAsyncWaitAll();
    store<T, D>(dK + (size_t)bh * seqK * D, dk, k0 + warp * 16, seqK, scale, lane);
    store<T, D>(dV + (size_t)bh * seqK * D, dv, k0 + warp * 16, seqK, 1.0f, lane);
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

template <typename T, int D>
cudaError_t launchDq(const Args& a)
{
    constexpr int bytes = tileBytes<T, D>();
    static bool sized = false;
    const cudaError_t err = allowSmem(flashBackwardDq<T, D>, bytes, sized);
    if (err != cudaSuccess)
        return err;

    const dim3 grid(a.bh, (a.seqQ + BQ - 1) / BQ);
    flashBackwardDq<T, D><<<grid, THREADS, bytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dq), a.seqQ, a.seqK, a.causal,
        1.0f / sqrtf((float)D));
    return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launchDkv(const Args& a)
{
    constexpr int bytes = tileBytes<T, D>() + 4 * BQ * (int)sizeof(float);
    static bool sized = false;
    const cudaError_t err = allowSmem(flashBackwardDkv<T, D>, bytes, sized);
    if (err != cudaSuccess)
        return err;

    const dim3 grid(a.bh, (a.seqK + BK - 1) / BK);
    flashBackwardDkv<T, D><<<grid, THREADS, bytes, a.stream>>>(
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
