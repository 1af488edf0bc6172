// Tiled GEMM C = A @ B for Hopper (sm_90a), row-major, f32 accumulation (int32
// for int8 operands).
//
// Replaces the Pallas TPU kernel puzzlelib_tpu/ops/pallas/matmul.py
// `_matmulKernel` (wrappers `matmul`, `matmulPadded`): an (M/bm, N/bn, K/bk)
// grid with K innermost and an f32 scratch accumulator.  On the TPU the K axis
// is a sequential grid dimension that revisits one VMEM accumulator; here each
// block owns one output tile and walks its share of K in a loop, keeping the
// accumulator in registers, because Hopper blocks run in no order and share
// nothing.
//
// What bounds it on the H100: at the serving shapes (M = batch = 32 rows, the
// VGG-16 fc layers) the product is bound by reading B (the weights) from
// device memory: fc6 streams 25088 x 4096 bf16 = 205 MB for 6.6 GFLOP, some
// 32 FLOP per byte, far under the ~295 the tensor cores need.  Streaming at
// HBM rate needs many bytes in flight on every SM, so:
//   - split-K: when the output tiles alone give fewer than two blocks per SM
//     (N / 64 = 64 blocks for fc6 at M = 32), K is cut into slices run by
//     separate blocks; each writes an f32 partial tile, and a second kernel
//     sums the slices in a fixed order (deterministic) and rounds once;
//   - a three-stage cp.async ring of A and B tiles, so two tiles are in
//     flight while the tensor cores work on the third.
// wgmma and TMA are the later steps.
//
// Types:
//   bf16, f16 - WMMA 16x16x16 tensor-core fragments with f32 accumulators;
//               64x64 block tile, BK = 32, four warps of 32x32.  Ragged M, N
//               and K are masked at load (zero fill) and store; nothing is
//               padded in device memory as `matmulPadded` pads.  Rows whose K
//               and N are multiples of 8 load as 16-byte cp.async vectors;
//               other shapes load element by element.
//   f32       - FFMA only.  Hopper's tensor cores have no f32 mode (TF32
//               keeps ~10 mantissa bits), and the reference runs f32 at
//               HIGHEST precision, so f32 stays on the CUDA cores:
//               64x64 block tile, BK = 16, 256 threads of 4x4 outputs, with
//               the same split-K.
//   int8      - K1-int8, the reference's int8 operands with an exact int32
//               accumulator and an int32 output (matmul.py:54-56), the
//               product of the int8 serving engine.  WMMA 16x16x16 s8
//               fragments with int32 accumulators; 64x64 block tile,
//               BK = 64 (64 bytes a row, as bf16's 32); the same cp.async
//               ring and split-K, but the partial tiles are int32: integer
//               sums are exact in any order (|acc| <= K * 127^2, 4.05e8 at
//               K = 25088, below 2^31).  WMMA wants every 8-bit fragment on
//               a 32-byte boundary, which a 16-byte K step breaks in a
//               row-major tile, so the shared tiles are kept as 16-column
//               slabs: A as [k / 16][m][16], B as [n / 16][k][16], each
//               fragment a contiguous 256-byte block.  Slabs are 1056 bytes
//               apart (64 rows and two 16-byte chunks of padding), so the
//               16-byte cp.async stores of one quarter-warp (two rows, four
//               slabs) fall into eight distinct bank groups.  Rows whose K
//               and N are multiples of 16 load as 16-byte vectors; other
//               shapes (conv1_1's K = 27, fc8's N = 1000) byte by byte.
//               What bounds it on the H100: at the engine's conv shapes
//               (M = 32 H W rows) the operations, 2 M N K at 1979 TOP/s; at
//               its fc layers (M = 32) reading the weights.
//
// Entries: pl_matmul_splits(...) gives the number of K slices a shape takes
// (the caller allocates that many partial tiles of M x N when it is more
// than one: f32, or int32 for int8); pl_matmul(...) launches and returns the
// cudaError_t of cudaGetLastError().  The caller allocates C and owns the
// stream.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int HBM = 64, HBN = 64, HBK = 32, HTHREADS = 128, STAGES = 3;
constexpr int HLDA = HBK + 8;   // shared row pitches, in elements: multiples of 8
constexpr int HLDB = HBN + 8;   // (16 bytes) as WMMA wants, and off the bank period
constexpr int HLDC = HBN + 4;   // floats
constexpr int A_STAGE = HBM * HLDA;
constexpr int B_STAGE = HBK * HLDB;
constexpr int H_SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;
static_assert(HBM * HLDC * 4 <= H_SMEM_BYTES, "the epilogue tile reuses the ring");

constexpr int SBM = 64, SBN = 64, SBK = 16, STM = 4, STN = 4;
constexpr int STHREADS = (SBM / STM) * (SBN / STN);   // 256

// a slice gets at least this many K tiles, so its prologue and epilogue stay
// small against its loop
constexpr int MIN_TILES_PER_SLICE = 4;

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

template <int N>
__device__ __forceinline__ void cpAsyncWait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

template <typename T, bool VEC>
__device__ __forceinline__ void loadTiles(T* As, T* Bs, const T* __restrict__ A, const T* __restrict__ B,
                                          int M, int N, int K, int m0, int n0, int k0, int tid)
{
    if (VEC) {
        // with K % 8 == 0 and N % 8 == 0 a vector is wholly inside or outside
#pragma unroll
        for (int v = tid; v < HBM * HBK / 8; v += HTHREADS) {
            const int r = v / (HBK / 8), c = (v % (HBK / 8)) * 8;
            const int gm = m0 + r, gk = k0 + c;
            const bool ok = gm < M && gk < K;
            cpAsync16(As + r * HLDA + c, ok ? A + (size_t)gm * K + gk : A, ok);
        }
#pragma unroll
        for (int v = tid; v < HBK * HBN / 8; v += HTHREADS) {
            const int r = v / (HBN / 8), c = (v % (HBN / 8)) * 8;
            const int gk = k0 + r, gn = n0 + c;
            const bool ok = gk < K && gn < N;
            cpAsync16(Bs + r * HLDB + c, ok ? B + (size_t)gk * N + gn : B, ok);
        }
    } else {
        const T zero = T(0.0f);
        for (int e = tid; e < HBM * HBK; e += HTHREADS) {
            const int r = e / HBK, c = e % HBK;
            const int gm = m0 + r, gk = k0 + c;
            As[r * HLDA + c] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : zero;
        }
        for (int e = tid; e < HBK * HBN; e += HTHREADS) {
            const int r = e / HBN, c = e % HBN;
            const int gk = k0 + r, gn = n0 + c;
            Bs[r * HLDB + c] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : zero;
        }
    }
}

// one (64 x 64) output tile over K tiles [z * tilesPerSlice, (z + 1) * tilesPerSlice);
// with one slice the tile goes to C, else to partial[z] in f32
template <typename T, bool VEC>
__global__ void __launch_bounds__(HTHREADS)
gemmTensorCore(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
               float* __restrict__ partial, int M, int N, int K, int tilesPerSlice)
{
    __shared__ __align__(128) unsigned char smem[H_SMEM_BYTES];
    T* As = reinterpret_cast<T*>(smem);
    T* Bs = As + STAGES * A_STAGE;
    float* Cs = reinterpret_cast<float*>(smem);

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int wm = warp >> 1, wn = warp & 1;
    const int m0 = blockIdx.y * HBM, n0 = blockIdx.x * HBN;

    const int kTiles = (K + HBK - 1) / HBK;
    const int kt0 = blockIdx.z * tilesPerSlice;
    const int nt = max(min(kt0 + tilesPerSlice, kTiles) - kt0, 0);

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nt)
            loadTiles<T, VEC>(As + s * A_STAGE, Bs + s * B_STAGE, A, B, M, N, K, m0, n0, (kt0 + s) * HBK, tid);
        cpAsyncCommit();
    }

    for (int i = 0; i < nt; ++i) {
        cpAsyncWait<STAGES - 2>();   // tile i has landed
        __syncthreads();             // ... for every thread, and tile i - 1 is consumed

        const int j = i + STAGES - 1;
        if (j < nt)
            loadTiles<T, VEC>(As + (j % STAGES) * A_STAGE, Bs + (j % STAGES) * B_STAGE, A, B, M, N, K,
                              m0, n0, (kt0 + j) * HBK, tid);
        cpAsyncCommit();

        const T* as = As + (i % STAGES) * A_STAGE;
        const T* bs = Bs + (i % STAGES) * B_STAGE;
#pragma unroll
        for (int kk = 0; kk < HBK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[2];
#pragma unroll
            for (int r = 0; r < 2; ++r)
                wmma::load_matrix_sync(a[r], as + (wm * 32 + r * 16) * HLDA + kk, HLDA);
#pragma unroll
            for (int c = 0; c < 2; ++c)
                wmma::load_matrix_sync(b[c], bs + kk * HLDB + wn * 32 + c * 16, HLDB);
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
                for (int c = 0; c < 2; ++c)
                    wmma::mma_sync(acc[r][c], a[r], b[c], acc[r][c]);
        }
    }

    cpAsyncWait<0>();
    __syncthreads();   // the ring is idle: its space becomes the epilogue tile

#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c)
            wmma::store_matrix_sync(Cs + (wm * 32 + r * 16) * HLDC + wn * 32 + c * 16,
                                    acc[r][c], HLDC, wmma::mem_row_major);
    __syncthreads();

    float* out = partial + (size_t)blockIdx.z * M * N;
    for (int e = tid; e < HBM * HBN; e += HTHREADS) {
        const int r = e / HBN, c = e % HBN;
        const int gm = m0 + r, gn = n0 + c;
        if (gm < M && gn < N) {
            if (gridDim.z == 1)
                C[(size_t)gm * N + gn] = T(Cs[r * HLDC + c]);
            else
                out[(size_t)gm * N + gn] = Cs[r * HLDC + c];
        }
    }
}

__global__ void __launch_bounds__(STHREADS)
gemmF32(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
        float* __restrict__ partial, int M, int N, int K, int tilesPerSlice)
{
    __shared__ float As[SBK][SBM + 4];   // A tile stored k-major: As[k][m]
    __shared__ float Bs[SBK][SBN + 4];

    const int tid = threadIdx.x;
    const int tx = tid % (SBN / STN), ty = tid / (SBN / STN);
    const int m0 = blockIdx.y * SBM, n0 = blockIdx.x * SBN;

    const int kTiles = (K + SBK - 1) / SBK;
    const int kt0 = blockIdx.z * tilesPerSlice;
    const int kt1 = min(kt0 + tilesPerSlice, kTiles);

    float acc[STM][STN];
#pragma unroll
    for (int i = 0; i < STM; ++i)
#pragma unroll
        for (int j = 0; j < STN; ++j)
            acc[i][j] = 0.0f;

    for (int kt = kt0; kt < kt1; ++kt) {
        const int k0 = kt * SBK;
#pragma unroll
        for (int e = tid; e < SBM * SBK; e += STHREADS) {
            const int r = e / SBK, c = e % SBK;
            const int gm = m0 + r, gk = k0 + c;
            As[c][r] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.0f;
        }
#pragma unroll
        for (int e = tid; e < SBK * SBN; e += STHREADS) {
            const int r = e / SBN, c = e % SBN;
            const int gk = k0 + r, gn = n0 + c;
            Bs[r][c] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : 0.0f;
        }
        __syncthreads();

#pragma unroll
        for (int kk = 0; kk < SBK; ++kk) {
            float a[STM], b[STN];
#pragma unroll
            for (int i = 0; i < STM; ++i)
                a[i] = As[kk][ty * STM + i];
#pragma unroll
            for (int j = 0; j < STN; ++j)
                b[j] = Bs[kk][tx * STN + j];
#pragma unroll
            for (int i = 0; i < STM; ++i)
#pragma unroll
                for (int j = 0; j < STN; ++j)
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

    float* out = gridDim.z == 1 ? C : partial + (size_t)blockIdx.z * M * N;
#pragma unroll
    for (int i = 0; i < STM; ++i) {
        const int gm = m0 + ty * STM + i;
#pragma unroll
        for (int j = 0; j < STN; ++j) {
            const int gn = n0 + tx * STN + j;
            if (gm < M && gn < N)
                out[(size_t)gm * N + gn] = acc[i][j];
        }
    }
}

// -- K1-int8 -------------------------------------------------------------------

constexpr int IBM = 64, IBN = 64, IBK = 64;
constexpr int ISLAB = IBM * 16 + 32;                  // bytes: 64 rows of 16, two chunks of padding
constexpr int IA_STAGE = (IBK / 16) * ISLAB;          // A: one slab per 16 columns of K
constexpr int IB_STAGE = (IBN / 16) * ISLAB;          // B: one slab per 16 columns of N (IBK = 64 rows)
constexpr int I_SMEM_BYTES = STAGES * (IA_STAGE + IB_STAGE);
constexpr int ILDC = IBN + 4;                         // ints
static_assert(IBK == IBM, "an A slab and a B slab hold the same 64 rows");
static_assert(ISLAB % 32 == 0, "every slab starts on a 32-byte boundary");
static_assert(IBM * ILDC * 4 <= I_SMEM_BYTES, "the epilogue tile reuses the ring");

template <bool VEC>
__device__ __forceinline__ void loadTilesInt8(int8_t* As, int8_t* Bs, const int8_t* __restrict__ A,
                                              const int8_t* __restrict__ B, int M, int N, int K, int m0, int n0,
                                              int k0, int tid)
{
    if (VEC) {
        // with K % 16 == 0 and N % 16 == 0 a vector is wholly inside or outside;
        // four threads read one 64-byte row segment
#pragma unroll
        for (int v = tid; v < IBM * IBK / 16; v += HTHREADS) {
            const int r = v / (IBK / 16), c = v % (IBK / 16);
            const int gm = m0 + r, gk = k0 + c * 16;
            const bool ok = gm < M && gk < K;
            cpAsync16(As + c * ISLAB + r * 16, ok ? A + (size_t)gm * K + gk : A, ok);
        }
#pragma unroll
        for (int v = tid; v < IBK * IBN / 16; v += HTHREADS) {
            const int r = v / (IBN / 16), c = v % (IBN / 16);
            const int gk = k0 + r, gn = n0 + c * 16;
            const bool ok = gk < K && gn < N;
            cpAsync16(Bs + c * ISLAB + r * 16, ok ? B + (size_t)gk * N + gn : B, ok);
        }
    } else {
        for (int e = tid; e < IBM * IBK; e += HTHREADS) {
            const int r = e / IBK, c = e % IBK;
            const int gm = m0 + r, gk = k0 + c;
            As[(c / 16) * ISLAB + r * 16 + c % 16] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : int8_t(0);
        }
        for (int e = tid; e < IBK * IBN; e += HTHREADS) {
            const int r = e / IBN, c = e % IBN;
            const int gk = k0 + r, gn = n0 + c;
            Bs[(c / 16) * ISLAB + r * 16 + c % 16] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : int8_t(0);
        }
    }
}

// one (64 x 64) int32 output tile over K tiles [z * tilesPerSlice, (z + 1) * tilesPerSlice);
// with one slice the tile goes to C, else to partial[z]
template <bool VEC>
__global__ void __launch_bounds__(HTHREADS)
gemmInt8(const int8_t* __restrict__ A, const int8_t* __restrict__ B, int* __restrict__ C, int* __restrict__ partial,
         int M, int N, int K, int tilesPerSlice)
{
    __shared__ __align__(128) unsigned char smem[I_SMEM_BYTES];
    int8_t* As = reinterpret_cast<int8_t*>(smem);
    int8_t* Bs = As + STAGES * IA_STAGE;
    int* Cs = reinterpret_cast<int*>(smem);

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int wm = warp >> 1, wn = warp & 1;
    const int m0 = blockIdx.y * IBM, n0 = blockIdx.x * IBN;

    const int kTiles = (K + IBK - 1) / IBK;
    const int kt0 = blockIdx.z * tilesPerSlice;
    const int nt = max(min(kt0 + tilesPerSlice, kTiles) - kt0, 0);

    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::fill_fragment(acc[i][j], 0);

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nt)
            loadTilesInt8<VEC>(As + s * IA_STAGE, Bs + s * IB_STAGE, A, B, M, N, K, m0, n0, (kt0 + s) * IBK, tid);
        cpAsyncCommit();
    }

    for (int i = 0; i < nt; ++i) {
        cpAsyncWait<STAGES - 2>();   // tile i has landed
        __syncthreads();             // ... for every thread, and tile i - 1 is consumed

        const int j = i + STAGES - 1;
        if (j < nt)
            loadTilesInt8<VEC>(As + (j % STAGES) * IA_STAGE, Bs + (j % STAGES) * IB_STAGE, A, B, M, N, K,
                               m0, n0, (kt0 + j) * IBK, tid);
        cpAsyncCommit();

        const int8_t* as = As + (i % STAGES) * IA_STAGE;
        const int8_t* bs = Bs + (i % STAGES) * IB_STAGE;
#pragma unroll
        for (int kk = 0; kk < IBK / 16; ++kk) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> b[2];
#pragma unroll
            for (int r = 0; r < 2; ++r)
                wmma::load_matrix_sync(a[r], reinterpret_cast<const signed char*>(
                                                 as + kk * ISLAB + (wm * 32 + r * 16) * 16), 16);
#pragma unroll
            for (int c = 0; c < 2; ++c)
                wmma::load_matrix_sync(b[c], reinterpret_cast<const signed char*>(
                                                 bs + (wn * 2 + c) * ISLAB + kk * 16 * 16), 16);
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
                for (int c = 0; c < 2; ++c)
                    wmma::mma_sync(acc[r][c], a[r], b[c], acc[r][c]);
        }
    }

    cpAsyncWait<0>();
    __syncthreads();   // the ring is idle: its space becomes the epilogue tile

#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c)
            wmma::store_matrix_sync(Cs + (wm * 32 + r * 16) * ILDC + wn * 32 + c * 16,
                                    acc[r][c], ILDC, wmma::mem_row_major);
    __syncthreads();

    int* out = gridDim.z == 1 ? C : partial + (size_t)blockIdx.z * M * N;
    for (int e = tid; e < IBM * IBN; e += HTHREADS) {
        const int r = e / IBN, c = e % IBN;
        const int gm = m0 + r, gn = n0 + c;
        if (gm < M && gn < N)
            out[(size_t)gm * N + gn] = Cs[r * ILDC + c];
    }
}

// C = sum over the slices of the partial tiles, in slice order, rounded once
// (Acc f32 for the float types, int32 for int8, where the sum is exact)
template <typename Acc, typename T>
__global__ void sumSlices(const Acc* __restrict__ partial, T* __restrict__ C, long long size, int slices)
{
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < size;
         i += (long long)gridDim.x * blockDim.x) {
        Acc s = Acc(0);
        for (int z = 0; z < slices; ++z)
            s += partial[z * size + i];
        C[i] = T(s);
    }
}

void tileShape(int dtype, int* bm, int* bn, int* bk)
{
    switch (dtype) {
    case 0:  *bm = SBM; *bn = SBN; *bk = SBK; break;
    case 3:  *bm = IBM; *bn = IBN; *bk = IBK; break;
    default: *bm = HBM; *bn = HBN; *bk = HBK; break;
    }
}

template <typename T>
void launchTensorCore(const void* a, const void* b, void* c, float* partial, int m, int n, int k, bool vec,
                      int slices, int tilesPerSlice, cudaStream_t stream)
{
    const dim3 grid((n + HBN - 1) / HBN, (m + HBM - 1) / HBM, slices);
    const T* A = static_cast<const T*>(a);
    const T* B = static_cast<const T*>(b);
    T* C = static_cast<T*>(c);

    if (vec)
        gemmTensorCore<T, true><<<grid, HTHREADS, 0, stream>>>(A, B, C, partial, m, n, k, tilesPerSlice);
    else
        gemmTensorCore<T, false><<<grid, HTHREADS, 0, stream>>>(A, B, C, partial, m, n, k, tilesPerSlice);

    if (slices > 1)
        sumSlices<float, T><<<512, 256, 0, stream>>>(partial, C, (long long)m * n, slices);
}

}  // namespace

// The number of K slices for an (m, k) @ (k, n) product of type `dtype` on a
// card with `sms` SMs: one when the output tiles give two blocks per SM,
// else enough to reach that, with at least MIN_TILES_PER_SLICE K tiles each.
extern "C" int pl_matmul_splits(int m, int n, int k, int dtype, int sms)
{
    int bm, bn, bk;
    tileShape(dtype, &bm, &bn, &bk);

    const long long blocks = (long long)((m + bm - 1) / bm) * ((n + bn - 1) / bn);
    const int kTiles = (k + bk - 1) / bk;

    if (blocks >= 2LL * sms || kTiles < 2 * MIN_TILES_PER_SLICE)
        return 1;

    int slices = (int)((2LL * sms + blocks - 1) / blocks);
    if (slices > kTiles / MIN_TILES_PER_SLICE)
        slices = kTiles / MIN_TILES_PER_SLICE;

    const int perSlice = (kTiles + slices - 1) / slices;
    return (kTiles + perSlice - 1) / perSlice;
}

// dtype: 0 = f32, 1 = bf16, 2 = f16, 3 = int8 (C in int32).  vec: the caller
// has checked that A and B start on 16-byte boundaries and that K and N are
// multiples of 8 (16 for int8): one 16-byte vector.  partial: `slices` tiles
// of m x n, f32 (int32 for int8), used when slices > 1.
extern "C" int pl_matmul(const void* a, const void* b, void* c, void* partial, int m, int n, int k,
                         int dtype, int vec, int slices, void* stream)
{
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* part = static_cast<float*>(partial);

    if (slices < 1 || (slices > 1 && part == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);

    int bm, bn, bk;
    tileShape(dtype, &bm, &bn, &bk);
    const int kTiles = (k + bk - 1) / bk;
    const int tilesPerSlice = (kTiles + slices - 1) / slices;

    switch (dtype) {
    case 0: {
        const dim3 grid((n + SBN - 1) / SBN, (m + SBM - 1) / SBM, slices);
        gemmF32<<<grid, STHREADS, 0, s>>>(static_cast<const float*>(a), static_cast<const float*>(b),
                                          static_cast<float*>(c), part, m, n, k, tilesPerSlice);
        if (slices > 1)
            sumSlices<float, float><<<512, 256, 0, s>>>(part, static_cast<float*>(c), (long long)m * n, slices);
        break;
    }
    case 1:
        launchTensorCore<__nv_bfloat16>(a, b, c, part, m, n, k, vec != 0, slices, tilesPerSlice, s);
        break;
    case 2:
        launchTensorCore<__half>(a, b, c, part, m, n, k, vec != 0, slices, tilesPerSlice, s);
        break;
    case 3: {
        const dim3 grid((n + IBN - 1) / IBN, (m + IBM - 1) / IBM, slices);
        const int8_t* A = static_cast<const int8_t*>(a);
        const int8_t* B = static_cast<const int8_t*>(b);
        int* C = static_cast<int*>(c);
        int* ipart = static_cast<int*>(partial);
        if (vec)
            gemmInt8<true><<<grid, HTHREADS, 0, s>>>(A, B, C, ipart, m, n, k, tilesPerSlice);
        else
            gemmInt8<false><<<grid, HTHREADS, 0, s>>>(A, B, C, ipart, m, n, k, tilesPerSlice);
        if (slices > 1)
            sumSlices<int, int><<<512, 256, 0, s>>>(ipart, C, (long long)m * n, slices);
        break;
    }
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }

    return static_cast<int>(cudaGetLastError());
}
