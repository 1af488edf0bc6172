// Flash-attention forward for Hopper (sm_90a) on wgmma: out = softmax(q k^T /
// sqrt(d)) v and each query row's logsumexp, without the (seqQ, seqK) score
// matrix ever reaching shared or device memory.
//
// Replaces the Pallas TPU kernel puzzlelib_tpu/ops/pallas/flash.py
// `_flashKernel` (wrapper `_flashForward`): a (batch*heads, seqQ / bq) grid
// whose program holds one query block and walks the whole K and V with a
// running max m and sum l in f32 (the online softmax).  The semantics kept:
//   - S = (q k^T) * scale with f32 accumulation, scale = 1 / sqrt(d);
//   - the causal mask qPos + offset >= kPos with offset = seqK - seqQ (the
//     bottom-right alignment), masked scores set to -1e30 and not -inf, so a
//     row with no visible key averages v over every key as the TPU kernel's
//     does (lse = -1e30 + log(seqK));
//   - P rounded to the input's type for the P V product, l summing P in f32;
//   - out = acc / l in the input's type, lse = m + log(l) in f32.
// On the TPU the block sizes snap to divisors of the sequence (`_snapBlocks`);
// here the blocks are fixed and the ragged tails are masked: key columns past
// seqK get -inf (they add nothing, not even to a fully masked row), query
// rows past seqQ are computed and not stored.
//
// What bounds it on the H100: 4 * seqQ * seqK * d operations against reading
// q, k, v and writing out once: at d = 64 and seq 2048 some 500 operations a
// byte, above the ~295 the tensor cores need, so long sequences are bound by
// the tensor cores; at the transformer slice's seq 80, d = 32 it is ~20 a
// byte, bound by memory and by launch latency.  Two more limits sit close
// to the products: one exp2 per score on the SM's 16 MUFU lanes a clock
// takes about as long as the two products at d 64 on the tensor cores, and
// every block reads its batch * head's whole K and V, so L2 hands out
// seqQ / ROWS times their bytes.  The design overlaps the three across the
// warpgroups of an SM.
//
// The design, K5a's parts (csrc/flash_bwd.cu) turned into the forward and fed
// by the TMA ring of csrc/matmul.cu's gemmWgmma:
//   - a block owns ROWS = 64 WGS query rows, WGS consumer warpgroups of 64
//     (wgmma's M), and walks the key tiles of its batch * head; the
//     warpgroups of a block read the one K and V tile of a step, so two of
//     them halve L2's bytes against one.  WGS is 2, or 1 for small grids
//     and at d 64, where two-warpgroup blocks fit two to an SM only at a
//     register bound that spills (the caller chooses: ops/hopper/flash.py
//     `blockRows`);
//   - one producer warp loads Q once, then K and V tiles of 64 keys, by TMA
//     through a three-stage ring with a full and an empty mbarrier a stage;
//     a consumer warp releases a stage once its warpgroup's products that
//     read it have retired.  The tensor maps are 3-D over (d, seq, batch *
//     head), so a box at a head's end is filled with zeros by TMA: a 2-D map
//     over the flattened rows would read the next head's rows, masked to p
//     = 0, but 0 * Inf is NaN.  The boxes are one swizzle row wide: 128
//     bytes, 128-byte swizzled, at d 64 and 128 (two boxes of 64 columns at
//     d 128), 64 bytes, 64-byte swizzled, at d 32;
//   - S = Q K^T as m64n64k16 with both operands from shared memory,
//     K-major (SBO the swizzle atom's eight rows, the k16 step 32 bytes into
//     a box's rows); the online softmax on the accumulator registers, where
//     a row's values sit in a quad of threads, so its max and sum reduce by
//     two shuffles; exp2 in one MUFU instruction (ex2.approx.ftz), with the
//     scale and log2 e folded into one FMA in the tiles that need no mask;
//   - O += P V as m64n{d}k16: P rounded and repacked in registers as
//     register-A (the m64nN accumulator of a thread is its A fragment of a
//     product over those N columns, so no value moves between threads), V's
//     tile read MN-major, the transposed-B form bf16 and f16 allow (the k16
//     step 16 rows, LBO the distance between its boxes of 64 columns at
//     d 128).  O is rescaled by exp(m_old - m_new) between the products,
//     never while one is in flight;
//   - the first product of every sum starts it with scale-d 0, so no
//     instruction outside wgmma defines a sum inside a product's stage (or
//     ptxas serialises the products, C7515), and the warp index is
//     broadcast from lane 0 (`__shfl_sync`) so that ptxas sees the address
//     arithmetic on it as uniform (C7520);
//   - masks only where a tile needs them: the tiles at seqK's ragged end and,
//     with causal, on or above the diagonal; every other tile takes the
//     unmasked path;
//   - with causal, the key tiles wholly above the diagonal are skipped when
//     every row of the query tile sees at least one key (else the fully
//     masked rows need them, see above): the block walks up to its last
//     row's last key, and a warpgroup whose rows all see key 0 stops
//     computing at its own last row's (it still releases the stages);
//   - the grid runs the query tiles last first, so that under causal the
//     blocks with the most key tiles start first and the light ones fill
//     the tail;
//   - no atomics: the same bits on every call.
// ptxas (CUDA 12.8, sm_90a; bf16 and f16 alike): 90 / 106 / 138 registers
// at d 32 / 64 / 128 with 64 or 128 rows, no spill.
//
// The first kernel (`mmaSync::flashForward`: mma.sync m16n8k16 fed by ldmatrix,
// four warps of 16 rows, a two-stage K/V ring) stays below under its own
// entry, pl_flash_forward_mma, as the yardstick the new kernel is timed and
// checked against; no caller's path reaches it.
//
// Types: bf16 and f16, head dims 32, 64 and 128.  f32 is refused by the
// wrapper: Hopper's tensor cores have no f32 mode.
//
// Entries: pl_flash_forward(...) (rows 64 or 128 a block) and
// pl_flash_forward_mma(...) launch on the caller's stream and return the
// cudaError_t of cudaGetLastError() (cudaErrorInvalidValue for a type, head
// dim or block height they have no instance for).  The caller allocates out
// and lse.  pl_flash_forward_smem(d, rows) gives the dynamic shared memory
// of an instance (rows 0: the mma.sync kernel's).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr float MASKED = -1e30f;              // the TPU kernel's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

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

// The first kernel, the yardstick: one block of 4 warps per (batch*head, 64
// query rows), each warp 16 rows with its q fragments, row statistics and
// (16, d) f32 accumulator in registers; K and V tiles of 64 rows in pitched
// shared memory, double-buffered by cp.async; S and P V on mma.sync m16n8k16
// fed by ldmatrix, the S fragments reused as P's A fragments
namespace mmaSync {

constexpr int BQ = 64, BK = 64, THREADS = 128;

template <int D>
__host__ __device__ constexpr int pitch() { return D + 8; }       // 16 bytes of padding: ldmatrix rows hit distinct banks

template <typename T, int D>
constexpr int smemBytes() { return (BQ + 4 * BK) * pitch<D>() * (int)sizeof(T); }

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

// rows [row0, row0 + 64) of a (rows, D) matrix into a pitched shared tile;
// rows past the end are zero
template <typename T, int D>
__device__ __forceinline__ void loadTile(T* dst, const T* __restrict__ src, int row0, int rows, int tid)
{
    constexpr int VECS = D / 8;   // 16-byte vectors per row
#pragma unroll
    for (int v = tid; v < BK * VECS; v += THREADS) {
        const int r = v / VECS, c = (v % VECS) * 8;
        const bool ok = row0 + r < rows;
        cpAsync16(dst + r * pitch<D>() + c, ok ? src + (size_t)(row0 + r) * D + c : src, ok);
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flashForward(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
             T* __restrict__ O, float* __restrict__ LSE, int seqQ, int seqK, int causal, float scale)
{
    constexpr int P = pitch<D>();
    constexpr int DT = D / 8;     // n-tiles of the output, k16 chunks of S are D / 16

    extern __shared__ __align__(128) unsigned char smem[];
    T* Qs = reinterpret_cast<T*>(smem);
    T* Ks = Qs + BQ * P;          // two stages each
    T* Vs = Ks + 2 * BK * P;

    const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int offset = seqK - seqQ;

    const T* q = Q + (size_t)bh * seqQ * D;
    const T* k = K + (size_t)bh * seqK * D;
    const T* v = V + (size_t)bh * seqK * D;

    int nk = (seqK + BK - 1) / BK;
    if (causal && q0 + offset >= 0) {
        // every row of the tile sees key 0, so the tiles past its last
        // visible key add exactly nothing
        const int lastKey = min(seqK - 1, min(q0 + BQ - 1, seqQ - 1) + offset);
        nk = lastKey / BK + 1;
    }

    loadTile<T, D>(Qs, q, q0, seqQ, tid);
    loadTile<T, D>(Ks, k, 0, seqK, tid);
    loadTile<T, D>(Vs, v, 0, seqK, tid);
    cpAsyncCommit();

    // this thread's rows of the warp's 16: r and r + 8
    const int rowA = q0 + warp * 16 + (lane >> 2);
    const int rows[2] = {rowA, rowA + 8};

    uint32_t qf[D / 16][4];
    float acc[DT][4];
#pragma unroll
    for (int t = 0; t < DT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            acc[t][e] = 0.0f;

    float m[2] = {MASKED, MASKED}, l[2] = {0.0f, 0.0f};

    for (int j = 0; j < nk; ++j) {
        cpAsyncWaitAll();   // tile j (and q) has landed
        __syncthreads();    // ... for every thread, and tile j - 1 is consumed

        if (j == 0) {
#pragma unroll
            for (int c = 0; c < D / 16; ++c)
                ldmatrixX4(qf[c], Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + c * 16 + (lane >> 4) * 8);
        }

        if (j + 1 < nk) {
            loadTile<T, D>(Ks + ((j + 1) & 1) * BK * P, k, (j + 1) * BK, seqK, tid);
            loadTile<T, D>(Vs + ((j + 1) & 1) * BK * P, v, (j + 1) * BK, seqK, tid);
        }
        cpAsyncCommit();

        const T* ks = Ks + (j & 1) * BK * P;
        const T* vs = Vs + (j & 1) * BK * P;

        // S = q k^T for this warp's 16 rows and the tile's 64 keys
        float s[BK / 8][4];
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                s[n][e] = 0.0f;
#pragma unroll
            for (int c = 0; c < D / 32; ++c) {
                uint32_t b[4];
                ldmatrixX4(b, ks + (n * 8 + (lane & 7)) * P + c * 32 + (lane >> 3) * 8);
                mma<T>(s[n], qf[2 * c], b[0], b[1]);
                mma<T>(s[n], qf[2 * c + 1], b[2], b[3]);
            }
        }

        // scale, mask, and the new row maxima
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = j * BK + n * 8 + (lane & 3) * 2 + (e & 1);
                float x = s[n][e] * scale;
                if (key >= seqK)
                    x = -INFINITY;
                else if (causal && rows[e >> 1] + offset < key)
                    x = MASKED;
                s[n][e] = x;
                mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }

        float corr[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffff, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffff, mx[i], 2));
            corr[i] = exp2f((m[i] - mx[i]) * LOG2E);
            m[i] = mx[i];
            l[i] *= corr[i];
        }

#pragma unroll
        for (int t = 0; t < DT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                acc[t][e] *= corr[e >> 1];

#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = exp2f((s[n][e] - m[e >> 1]) * LOG2E);
                s[n][e] = p;
                l[e >> 1] += p;
            }

        // acc += P V: the S fragments of key n-tiles 2c and 2c + 1 are the A
        // fragment of the c-th 16 keys
#pragma unroll
        for (int c = 0; c < BK / 16; ++c) {
            const uint32_t a[4] = {pack2<T>(s[2 * c][0], s[2 * c][1]), pack2<T>(s[2 * c][2], s[2 * c][3]),
                                   pack2<T>(s[2 * c + 1][0], s[2 * c + 1][1]),
                                   pack2<T>(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
            for (int t = 0; t < DT; t += 2) {
                uint32_t b[4];
                ldmatrixX4Trans(b, vs + (c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + t * 8 + (lane >> 4) * 8);
                mma<T>(acc[t], a, b[0], b[1]);
                mma<T>(acc[t + 1], a, b[2], b[3]);
            }
        }
    }

    cpAsyncWaitAll();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffff, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffff, l[i], 2);
    }

    T* o = O + (size_t)bh * seqQ * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        if (rows[i] >= seqQ)
            continue;

        const float inv = 1.0f / l[i];
#pragma unroll
        for (int t = 0; t < DT; ++t)
            *reinterpret_cast<uint32_t*>(o + (size_t)rows[i] * D + t * 8 + (lane & 3) * 2) =
                pack2<T>(acc[t][2 * i] * inv, acc[t][2 * i + 1] * inv);

        if ((lane & 3) == 0)
            LSE[(size_t)bh * seqQ + rows[i]] = m[i] + logf(l[i]);
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int bh, int seqQ, int seqK, int causal, cudaStream_t stream)
{
    constexpr int bytes = smemBytes<T, D>();
    static bool sized = false;   // once per instance: above 48 KB needs the opt-in
    if (!sized) {
        const cudaError_t err = cudaFuncSetAttribute(flashForward<T, D>,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess)
            return err;
        sized = true;
    }

    const dim3 grid(bh, (seqQ + BQ - 1) / BQ);
    flashForward<T, D><<<grid, THREADS, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), lse,
        seqQ, seqK, causal, 1.0f / sqrtf((float)D));
    return cudaGetLastError();
}

template <typename T>
cudaError_t launchType(const void* q, const void* k, const void* v, void* o, float* lse,
                       int bh, int seqQ, int seqK, int d, int causal, cudaStream_t stream)
{
    switch (d) {
    case 32:  return launch<T, 32>(q, k, v, o, lse, bh, seqQ, seqK, causal, stream);
    case 64:  return launch<T, 64>(q, k, v, o, lse, bh, seqQ, seqK, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, seqQ, seqK, causal, stream);
    default:  return cudaErrorInvalidValue;
    }
}


}  // namespace mmaSync

// the wgmma kernel
namespace wg {

constexpr int WG_ROWS = 64;     // a warpgroup's query rows: wgmma's M
constexpr int BK = 64;          // keys of a walked tile: the score product's N
constexpr int STAGES = 3;       // the K/V ring

// a TMA box's row: 128 bytes, 128-byte swizzled, at d 64 and 128 (64
// columns; d 128 takes two boxes); 64 bytes, 64-byte swizzled, at d 32
template <int D>
__host__ __device__ constexpr int swizzle() { return D == 32 ? 64 : 128; }

// WGS consumer warpgroups of 64 query rows each and one producer warp
template <int D, int WGS>
struct Ring {
    static constexpr int ROWS = WG_ROWS * WGS;
    static constexpr int THREADS = 128 * WGS + 32;
    static constexpr int Q_BYTES = ROWS * D * 2;
    static constexpr int TILE = BK * D * 2;          // one K or V tile
    static constexpr int STAGE = 2 * TILE;
    // Q, the stages, their full and empty barriers and Q's, and room to
    // align the boxes to the swizzle's period
    static constexpr int SMEM = Q_BYTES + STAGES * STAGE + (2 * STAGES + 1) * 8 + 1024;
    // two blocks an SM where their registers fit without a spill (d 32)
    static constexpr int MIN_BLOCKS = WGS == 2 && D == 32 ? 2 : 1;
};

__device__ __forceinline__ unsigned smemAddr(const void* p)
{
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barInit(uint64_t* bar, unsigned count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smemAddr(bar)), "r"(count) : "memory");
}

// the producer's arrival, announcing the bytes its TMA copies will bring
__device__ __forceinline__ void barExpect(uint64_t* bar, unsigned bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smemAddr(bar)), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void barArrive(uint64_t* bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smemAddr(bar)) : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void barWait(uint64_t* bar, unsigned parity)
{
    asm volatile("{\n.reg .pred done;\nWAIT:\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
                 "@!done bra WAIT;\n}\n" ::"r"(smemAddr(bar)), "r"(parity)
                 : "memory");
}

// one box of `map` at (column c0, row c1, batch * head c2) into dst, counted
// on bar; TMA writes zeros where the box leaves the matrix, so a box at a
// head's end reads nothing of the next head
__device__ __forceinline__ void tmaLoad(void* dst, const CUtensorMap* map, int c0, int c1, int c2, uint64_t* bar)
{
    asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smemAddr(dst)),
                 "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smemAddr(bar))
                 : "memory");
}

__device__ __forceinline__ void wgmmaFence()
{
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmmaCommit()
{
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmmaWait()
{
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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

// a shared-memory matrix descriptor of a swizzled tile: SBO the eight rows
// of a swizzle atom, the layout 128-byte (1) or 64-byte (2) swizzle
template <int D>
__device__ __forceinline__ uint64_t swizzled(const void* p, int lbo)
{
    constexpr uint64_t mode = swizzle<D>() == 128 ? 1 : 2;
    return (uint64_t)((smemAddr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(8 * swizzle<D>() >> 4) << 32) | (mode << 62);
}

// a tile of boxes `box` bytes apart as the K-major operand of a product over
// its columns: k-slice kc, 32 bytes a slice into a box's swizzled rows
template <int D>
__device__ __forceinline__ uint64_t kMajor(const unsigned char* tile, int box, int kc)
{
    constexpr int PER_BOX = swizzle<D>() / 32;
    return swizzled<D>(tile + kc / PER_BOX * box + 32 * (kc % PER_BOX), 16);
}

// a V tile as the MN-major B of a product over its rows: k-slice c, rows 16
// c .. 16 c + 15; LBO the distance between its boxes of columns
template <int D>
__device__ __forceinline__ uint64_t mnMajor(const unsigned char* tile, int c)
{
    return swizzled<D>(tile + 16 * swizzle<D>() * c, BK * swizzle<D>());
}

#define PL_OUT8(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define PL_OUT16(d) PL_OUT8(d, 0), PL_OUT8(d, 8)
#define PL_OUT32(d) PL_OUT16(d), PL_OUT8(d, 16), PL_OUT8(d, 24)
#define PL_OUT64(d) PL_OUT32(d), PL_OUT8(d, 32), PL_OUT8(d, 40), PL_OUT8(d, 48), PL_OUT8(d, 56)

// d = A B + (accumulate ? d : 0), m64nNk16 in f32, N = 2 x the length of d:
// SS (the scores, N = 64) takes A and B from shared memory, both K-major; RS
// (O += P V, N = d) takes A from registers and B from shared memory,
// MN-major (transposed)
#define PL_WGMMA_SS_N64(TY) \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
                 "%32, %33, p, 1, 1, 0, 0;\n}\n" \
                 : PL_OUT32(d) : "l"(da), "l"(db), "r"(accumulate))

#define PL_WGMMA_RS_N32(TY) \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, " \
                 "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n" \
                 : PL_OUT16(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate))

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

// a (64, BK) f32 accumulator rounded to T as the register-A fragments of a
// product over its BK columns: a thread's accumulator values 8 c .. 8 c + 7
// (rows r, r + 8; columns 16 c + 2 (lane % 4) (+ 1) and 8 more) are its
// fragment of k-slice c
template <typename T>
__device__ __forceinline__ void toOperand(uint32_t (&a)[BK / 16][4], const float (&x)[BK / 2])
{
#pragma unroll
    for (int c = 0; c < BK / 16; ++c)
#pragma unroll
        for (int r = 0; r < 4; ++r)
            a[c][r] = pack2<T>(x[8 * c + 2 * r], x[8 * c + 2 * r + 1]);
}

// the key tiles that query rows [r0, r0 + n) need: all of them or, with
// causal where every one of those rows sees key 0, those up to the last
// row's last visible key (the tiles past it add exactly nothing)
__device__ __forceinline__ int keyTiles(int r0, int n, int seqQ, int seqK, int causal)
{
    const int offset = seqK - seqQ;
    if (causal && r0 + offset >= 0)
        return (min(seqK - 1, min(r0 + n - 1, seqQ - 1) + offset)) / BK + 1;
    return (seqK + BK - 1) / BK;
}

// 2^x in one MUFU instruction; a result below f32's normal range, 2^-126 of
// the row's largest weight (which is 1), is flushed to 0
__device__ __forceinline__ float ex2(float x)
{
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// (out, lse) of ROWS = 64 WGS query rows of one batch * head, walking its
// key tiles.  Warps 0 .. 4 WGS - 1 are the consumer warpgroups, warp 4 WGS
// the producer
template <typename T, int D, int WGS>
__global__ void __launch_bounds__(Ring<D, WGS>::THREADS, Ring<D, WGS>::MIN_BLOCKS)
flashForward(const __grid_constant__ CUtensorMap mapQ, const __grid_constant__ CUtensorMap mapK,
             const __grid_constant__ CUtensorMap mapV, T* __restrict__ O, float* __restrict__ LSE,
             int bhs, int seqQ, int seqK, int causal, float scale)
{
    using R = Ring<D, WGS>;
    constexpr int SW = swizzle<D>(), BOXES = 2 * D / SW, Q_BOX = R::ROWS * SW, KV_BOX = BK * SW;

    extern __shared__ __align__(128) unsigned char smemRaw[];
    unsigned char* const smem = smemRaw + ((1024 - (smemAddr(smemRaw) & 1023)) & 1023);
    unsigned char* const qs = smem;
    unsigned char* const ring = smem + R::Q_BYTES;   // per stage: k, v
    uint64_t* const full = reinterpret_cast<uint64_t*>(ring + STAGES * R::STAGE);
    uint64_t* const empty = full + STAGES;
    uint64_t* const qBar = empty + STAGES;

    // the query tiles in the grid's slow dimension, the last first: under
    // causal the tiles with the most keys start first and the light ones
    // fill the tail
    const int tiles = (seqQ + R::ROWS - 1) / R::ROWS;
    const int bh = blockIdx.x % bhs, q0 = (tiles - 1 - (int)(blockIdx.x / bhs)) * R::ROWS;
    const int tid = threadIdx.x, lane = tid & 31;
    const int warp = __shfl_sync(0xFFFFFFFFu, tid >> 5, 0);   // uniform: ptxas keeps the products asynchronous
    const int offset = seqK - seqQ;
    const int nk = keyTiles(q0, R::ROWS, seqQ, seqK, causal);

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            barInit(&full[s], 1);
            barInit(&empty[s], 4 * WGS);   // lane 0 of every consumer warp
        }
        barInit(qBar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == 4 * WGS) {
        // the producer: one thread loads Q, then keeps the ring full
        if (lane == 0) {
            barExpect(qBar, R::Q_BYTES);
            for (int b = 0; b < BOXES; ++b)
                tmaLoad(qs + b * Q_BOX, &mapQ, b * SW / 2, q0, bh, qBar);

            for (int j = 0; j < nk; ++j) {
                const int s = j % STAGES;
                if (j >= STAGES)
                    barWait(&empty[s], (j / STAGES - 1) & 1);

                unsigned char* st = ring + s * R::STAGE;
                barExpect(&full[s], R::STAGE);
                for (int b = 0; b < BOXES; ++b) {
                    tmaLoad(st + b * KV_BOX, &mapK, b * SW / 2, j * BK, bh, &full[s]);
                    tmaLoad(st + R::TILE + b * KV_BOX, &mapV, b * SW / 2, j * BK, bh, &full[s]);
                }
            }
        }
        return;
    }

    // a consumer warpgroup: query rows q0 + 64 wg .. + 63.  It computes on
    // the tiles its own rows need (none if they all lie past seqQ) and
    // releases every tile of the block's walk.  A thread's accumulator rows:
    // queries q0 + row (+ 8); its columns of a key tile: 8 n + col (+ 1).
    // Rows past seqQ are zero in q and are not stored
    const int wg = warp >> 2;
    const int w0 = q0 + WG_ROWS * wg;
    const int nkOwn = w0 < seqQ ? keyTiles(w0, WG_ROWS, seqQ, seqK, causal) : 0;
    const int row = WG_ROWS * wg + 16 * (warp & 3) + (lane >> 2), col = 2 * (lane & 3);
    const unsigned char* qw = qs + wg * WG_ROWS * SW;
    const float scaleLog2 = scale * LOG2E;

    float acc[D / 2];   // set by its first product
    float m[2] = {MASKED, MASKED}, l[2] = {0.0f, 0.0f};

    barWait(qBar, 0);
    for (int j = 0; j < nk; ++j) {
        const int stage = j % STAGES;
        const unsigned char* kts = ring + stage * R::STAGE;
        const unsigned char* vts = kts + R::TILE;
        const bool own = j < nkOwn;   // uniform in the warpgroup

        barWait(&full[stage], (j / STAGES) & 1);

        // S = Q K^T over the tile's keys
        float s[BK / 2];   // set by its first product
        if (own) {
            wgmmaFence();
#pragma unroll
            for (int kc = 0; kc < D / 16; ++kc)
                wgmmaSS<T>(s, kMajor<D>(qw, Q_BOX, kc), kMajor<D>(kts, KV_BOX, kc), kc > 0);
            wgmmaCommit();
        }
        wgmmaWait();       // S is done, and step j - 1's P V products: tile j - 1 is free
        if (j > 0 && lane == 0)
            barArrive(&empty[(j - 1) % STAGES]);
        if (!own)
            continue;
        fenceSum(s);
        fenceSum(acc);

        // the new row maxima over the tile's keys (the columns); a thread's
        // s[i] is row row + 8 ((i / 2) % 2), key kt0 + 8 (i / 4) + col + i % 2
        const int kt0 = j * BK;
        const bool edge = kt0 + BK > seqK || (causal && w0 + offset < kt0 + BK - 1);
        float mx[2] = {m[0], m[1]};
        if (!edge) {
            // the raw scores' max: scale > 0 keeps the order
            float top[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int i = 0; i < BK / 2; ++i)
                top[(i >> 1) & 1] = fmaxf(top[(i >> 1) & 1], s[i]);
#pragma unroll
            for (int h = 0; h < 2; ++h)
                mx[h] = fmaxf(mx[h], top[h] * scale);
        } else {
            // scale, and mask: keys past seqK -inf, the causal mask -1e30
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) {
                const int h = (i >> 1) & 1, key = kt0 + 8 * (i >> 2) + col + (i & 1);
                float x = s[i] * scale;
                if (key >= seqK)
                    x = -INFINITY;
                else if (causal && q0 + row + 8 * h + offset < key)
                    x = MASKED;
                s[i] = x;
                mx[h] = fmaxf(mx[h], x);
            }
        }

        float corr[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xFFFFFFFFu, mx[h], 1));
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xFFFFFFFFu, mx[h], 2));
            corr[h] = ex2((m[h] - mx[h]) * LOG2E);
            m[h] = mx[h];
        }

        // P = exp(s scale - m): in an unmasked tile m is a score of the row,
        // so the FMA form is safe; a masked one subtracts first, so that a
        // row's -1e30 minus its max -1e30 is exactly 0
        float sum[2] = {0.0f, 0.0f};
        if (!edge) {
            const float ml[2] = {m[0] * LOG2E, m[1] * LOG2E};
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) {
                s[i] = ex2(fmaf(s[i], scaleLog2, -ml[(i >> 1) & 1]));
                sum[(i >> 1) & 1] += s[i];
            }
        } else {
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) {
                s[i] = ex2((s[i] - m[(i >> 1) & 1]) * LOG2E);
                sum[(i >> 1) & 1] += s[i];
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
            l[h] = l[h] * corr[h] + sum[h];

        // O = O corr + P V: the rescale while no product is in flight
        if (j > 0) {
#pragma unroll
            for (int i = 0; i < D / 2; ++i)
                acc[i] *= corr[(i >> 1) & 1];
        }

        uint32_t pa[BK / 16][4];
        toOperand<T>(pa, s);
        // the fragments and the sum are written before the fence, not moved past it
        fenceFragments(pa);
        fenceSum(acc);
        wgmmaFence();
#pragma unroll
        for (int c = 0; c < BK / 16; ++c)
            wgmmaRS<T>(acc, pa[c], mnMajor<D>(vts, c), !(j == 0 && c == 0));
        wgmmaCommit();
    }

    wgmmaWait();
    if (nkOwn == 0)
        return;
    fenceSum(acc);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xFFFFFFFFu, l[h], 1);
        l[h] += __shfl_xor_sync(0xFFFFFFFFu, l[h], 2);
    }

    T* o = O + (size_t)bh * seqQ * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = q0 + row + 8 * h;
        if (r >= seqQ)
            continue;

        const float inv = 1.0f / l[h];
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
            *reinterpret_cast<uint32_t*>(o + (size_t)r * D + 8 * n + col) =
                pack2<T>(acc[4 * n + 2 * h] * inv, acc[4 * n + 2 * h + 1] * inv);

        if ((lane & 3) == 0)
            LSE[(size_t)bh * seqQ + r] = m[h] + logf(l[h]);
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled as the CUDA runtime finds it in the CUDA driver it loaded
EncodeTiled findEncoder()
{
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(fn) : nullptr;
}

// (bh, seq, D) rows of T as TMA reads them: a 3-D map, so that a box at a
// head's end is filled with zeros and not with the next head's rows; boxes
// of boxRows rows of one swizzle row each
template <typename T, int D>
bool tensorMap(CUtensorMap* map, const void* base, int bh, int seq, int boxRows)
{
    static const EncodeTiled encode = findEncoder();
    if (encode == nullptr)
        return false;

    const CUtensorMapDataType type =
        std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)seq, (cuuint64_t)bh};
    const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)seq * D * 2};
    const cuuint32_t box[3] = {(cuuint32_t)(swizzle<D>() / 2), (cuuint32_t)boxRows, 1};
    const cuuint32_t steps[3] = {1, 1, 1};
    return encode(map, type, 3, const_cast<void*>(base), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  swizzle<D>() == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D, int WGS>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int bh, int seqQ, int seqK, int causal, cudaStream_t stream)
{
    using R = Ring<D, WGS>;
    static bool sized = false;   // once per instance: above 48 KB needs the opt-in
    if (!sized) {
        const cudaError_t err = cudaFuncSetAttribute(flashForward<T, D, WGS>,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
        if (err != cudaSuccess)
            return err;
        sized = true;
    }

    CUtensorMap mapQ, mapK, mapV;
    if (!tensorMap<T, D>(&mapQ, q, bh, seqQ, R::ROWS) || !tensorMap<T, D>(&mapK, k, bh, seqK, BK) ||
        !tensorMap<T, D>(&mapV, v, bh, seqK, BK))
        return cudaErrorInvalidValue;

    // one block per (batch * head, ROWS-row tile)
    const long long blocks = (long long)bh * ((seqQ + R::ROWS - 1) / R::ROWS);
    if (blocks > 0x7FFFFFFF)
        return cudaErrorInvalidValue;

    flashForward<T, D, WGS><<<(unsigned)blocks, R::THREADS, R::SMEM, stream>>>(
        mapQ, mapK, mapV, static_cast<T*>(o), lse, bh, seqQ, seqK, causal, 1.0f / sqrtf((float)D));
    return cudaGetLastError();
}

template <typename T, int WGS>
cudaError_t launchDim(const void* q, const void* k, const void* v, void* o, float* lse,
                      int bh, int seqQ, int seqK, int d, int causal, cudaStream_t stream)
{
    switch (d) {
    case 32:  return launch<T, 32, WGS>(q, k, v, o, lse, bh, seqQ, seqK, causal, stream);
    case 64:  return launch<T, 64, WGS>(q, k, v, o, lse, bh, seqQ, seqK, causal, stream);
    case 128: return launch<T, 128, WGS>(q, k, v, o, lse, bh, seqQ, seqK, causal, stream);
    default:  return cudaErrorInvalidValue;
    }
}

template <typename T>
cudaError_t launchType(const void* q, const void* k, const void* v, void* o, float* lse,
                       int bh, int seqQ, int seqK, int d, int causal, int rows, cudaStream_t stream)
{
    switch (rows) {
    case 64:  return launchDim<T, 1>(q, k, v, o, lse, bh, seqQ, seqK, d, causal, stream);
    case 128: return launchDim<T, 2>(q, k, v, o, lse, bh, seqQ, seqK, d, causal, stream);
    default:  return cudaErrorInvalidValue;
    }
}

}  // namespace wg

}  // namespace

// dtype: 1 bf16, 2 f16 (the numbering of matmul.cu; 0, f32, has no
// instance).  q, out: (bh, seqQ, d); k, v: (bh, seqK, d); lse: (bh, seqQ)
// f32.  rows: the query rows of a block, 64 or 128
extern "C" int pl_flash_forward(const void* q, const void* k, const void* v, void* o, float* lse,
                                int bh, int seqQ, int seqK, int d, int dtype, int causal, int rows, void* stream)
{
    const cudaStream_t s = static_cast<cudaStream_t>(stream);

    switch (dtype) {
    case 1:  return wg::launchType<__nv_bfloat16>(q, k, v, o, lse, bh, seqQ, seqK, d, causal, rows, s);
    case 2:  return wg::launchType<__half>(q, k, v, o, lse, bh, seqQ, seqK, d, causal, rows, s);
    default: return cudaErrorInvalidValue;
    }
}

// the first mma.sync kernel, the yardstick: the same arguments but rows
extern "C" int pl_flash_forward_mma(const void* q, const void* k, const void* v, void* o, float* lse,
                                    int bh, int seqQ, int seqK, int d, int dtype, int causal, void* stream)
{
    const cudaStream_t s = static_cast<cudaStream_t>(stream);

    switch (dtype) {
    case 1:  return mmaSync::launchType<__nv_bfloat16>(q, k, v, o, lse, bh, seqQ, seqK, d, causal, s);
    case 2:  return mmaSync::launchType<__half>(q, k, v, o, lse, bh, seqQ, seqK, d, causal, s);
    default: return cudaErrorInvalidValue;
    }
}

// the dynamic shared memory of an instance at head dim d, in bytes: the
// wgmma kernel's at `rows` query rows a block (64 or 128), the mma.sync
// kernel's at rows 0; 0 for an instance neither has
template <int D>
int smemOf(int rows)
{
    switch (rows) {
    case 0:   return mmaSync::smemBytes<__nv_bfloat16, D>();
    case 64:  return wg::Ring<D, 1>::SMEM;
    case 128: return wg::Ring<D, 2>::SMEM;
    default:  return 0;
    }
}

extern "C" int pl_flash_forward_smem(int d, int rows)
{
    switch (d) {
    case 32:  return smemOf<32>(rows);
    case 64:  return smemOf<64>(rows);
    case 128: return smemOf<128>(rows);
    default:  return 0;
    }
}
