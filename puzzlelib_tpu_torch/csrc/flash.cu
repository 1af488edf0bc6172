// Flash-attention forward for Hopper (sm_90a): out = softmax(q k^T / sqrt(d)) v
// and each query row's logsumexp, without the (seqQ, seqK) score matrix ever
// reaching device memory.
//
// Replaces the Pallas TPU kernel puzzlelib_tpu/ops/pallas/flash.py
// `_flashKernel` (wrapper `_flashForward`): a (batch*heads, seqQ / bq) grid
// whose program holds one query block and walks the whole K and V with a
// running max m and sum l in f32 (the online softmax).  The semantics kept:
//   - S = (q k^T) * scale with f32 accumulation, scale = 1 / sqrt(d);
//   - the causal mask qPos + offset >= kPos with offset = seqK - seqQ (the
//     bottom-right alignment), masked scores set to -1e30 and not -inf, so a
//     row with no visible key averages v over every key as the TPU kernel's
//     does;
//   - out = acc / l in the input's type, lse = m + log(l) in f32.
// On the TPU the block sizes snap to divisors of the sequence (`_snapBlocks`);
// here the blocks are fixed at 64 and the ragged tails are masked: key
// columns past seqK get -inf (they add nothing, not even to a fully masked
// row), query rows past seqQ are computed and not stored.
//
// What bounds it on the H100: 4 * seqQ * seqK * d FLOP against reading q, k, v
// and writing out once: at d = 64 and seq 2048 some 500 FLOP per byte, above
// the ~295 the tensor cores need, so long sequences are bound by the tensor
// cores; at the transformer slice's seq 80, d = 32 it is ~20 FLOP per byte
// and bound by memory and by launch latency.  This first version is simple:
//   - one block of 4 warps per (batch*head, 64 query rows); each warp owns 16
//     rows and keeps its q fragments, its row statistics and its (16, d) f32
//     accumulator in registers for the whole walk;
//   - K and V tiles of 64 rows in shared memory, double-buffered with
//     cp.async so the next tile lands while this one is used;
//   - S and P V on mma.sync m16n8k16 (bf16 or f16 in, f32 accumulators); the
//     S accumulator fragments are exactly the A fragments of P V, so P never
//     leaves the registers; P is rounded to the input type for that product,
//     as the TPU's one-pass bf16 product rounds it, and l sums P in f32;
//   - the row max and sum reduced over each row's quad of threads by shuffles;
//   - with causal, the key tiles wholly above the diagonal are skipped when
//     every row of the query tile sees at least one key (else the fully
//     masked rows need them, see above).
// wgmma, TMA and warp specialisation are the later steps.
//
// Types: bf16 and f16, head dims 32, 64 and 128.  f32 is refused by the
// wrapper: Hopper's tensor cores have no f32 mode.
//
// Entry: pl_flash_forward(...) launches on the caller's stream and returns the
// cudaError_t of cudaGetLastError() (cudaErrorInvalidValue for a type or head
// dim it has no instance for).  The caller allocates out and lse.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 128;
constexpr float MASKED = -1e30f;              // the TPU kernel's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

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

}  // namespace

// dtype: 1 bf16, 2 f16 (the numbering of matmul.cu; 0, f32, has no instance)
extern "C" int pl_flash_forward(const void* q, const void* k, const void* v, void* o, float* lse,
                                int bh, int seqQ, int seqK, int d, int dtype, int causal, void* stream)
{
    const cudaStream_t s = static_cast<cudaStream_t>(stream);

    switch (dtype) {
    case 1:  return launchType<__nv_bfloat16>(q, k, v, o, lse, bh, seqQ, seqK, d, causal, s);
    case 2:  return launchType<__half>(q, k, v, o, lse, bh, seqQ, seqK, d, causal, s);
    default: return cudaErrorInvalidValue;
    }
}
