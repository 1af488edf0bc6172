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
// What bounds it on the H100, shape by shape, and what the design does:
//   - fc6 (32 x 25088 x 4096, VGG-16 at batch 32) is bound by reading the
//     weights: 205 MB for 6.6 GFLOP, some 32 FLOP a byte against the ~295 the
//     tensor cores need, 0.062 ms at 3.35 TB/s.  Streaming at HBM rate needs
//     many bytes in flight on every SM.  Split-K: when the output tiles alone
//     give fewer than two blocks an SM, K is cut into slices run by separate
//     blocks; each writes an f32 partial tile, and a second kernel sums the
//     slices in a fixed order (deterministic) and rounds once.  fc6 then runs
//     288 blocks, two an SM, each with a four-stage TMA ring of 16 KB of
//     weights a stage: ~128 KB in flight an SM, on which no thread spends a
//     register or an instruction.  fc7 and fc8 are bytes-bound too, but their
//     33.5 MB and 8 MB of weights stay in the 50 MB L2 across back-to-back
//     calls, so timed calls can beat their HBM bound.
//   - The transformer's products (5120 x 128 x 512 and 5120 x 512 x 128, 64
//     rows of 80 tokens) move 6.7 MB each for 0.7 GFLOP: 2 us of bytes, and
//     launch and latency besides.  The design keeps the path from a tile's
//     arrival to its products and from the sums to device memory short: no
//     thread computes a load address, and the sums go from the registers
//     straight to device memory.
//   - 8192^3 is bound by the operations: 1.1 TFLOP, 1.1 ms at 989 TFLOP/s.
//     The 64 x 64 WMMA tiles of `gemmTensorCore` asked L2 for M N K 2 B (1/BN + 1/BM) = 34 GB,
//     some 6 ms of L2's delivery, against 8.6 ms measured: L2 bound it, and
//     WMMA (mma.sync) cannot reach Hopper's tensor-core rate anyway.  wgmma
//     reads 64 x 128 or 128 x 128 tiles straight from shared memory: 26 or
//     17 GB through L2.
//
// Types:
//   bf16, f16 - where TMA can describe the operands (K and N multiples of 8,
//               both bases on 16 bytes; the caller decides, from the shape
//               alone): `gemmWgmma`, warpgroup products fed by TMA.  A block
//               owns a 64 x 128 output tile with one consumer warpgroup, or
//               128 x 128 with two (the caller's choice for large products
//               bound by their operations), and walks K in steps of 64 (one
//               128-byte swizzle atom of A a row) through a four-stage ring
//               in dynamic shared memory.  One producer thread keeps the ring
//               full: per stage one TMA box of A (K-major, BM x 64) and two
//               of B ((K, N) row-major, so MN-major for wgmma: 64 K rows of
//               64 columns each), 128-byte swizzled, with a full and an empty
//               mbarrier.  TMA's zero fill masks the ragged M, N and K
//               edges; nothing is padded.  Each consumer warpgroup issues
//               four m64n128k16 products a step (B through wgmma's transpose
//               bit), keeps one group in flight (`wgmma.wait_group 1`) and
//               frees a stage only once the group that read it has retired.
//               The sums go from the registers to device memory as packed
//               pairs of the output type (f32 pairs for a split-K partial),
//               masked at the ragged edge.  TMA descriptors are encoded on
//               the host at each call through the CUDA driver's entry point
//               as the runtime hands it over (cudaGetDriverEntryPoint), so
//               that no CUDA driver library is linked.
//               Otherwise (the transformer head's N = 2, any ragged K or N):
//               WMMA 16x16x16 tensor-core fragments with f32 accumulators;
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
//               product of the int8 serving engine.  Integer sums are exact
//               in any order (|acc| <= K * 127^2, 4.05e8 at K = 25088, below
//               2^31), so split-K partials are int32 and any split gives the
//               same bits.
//               What bounds it on the H100, at the engine's shapes (batch
//               32; each input read once, each output written once, at 3.35
//               TB/s and 1979 TOP/s): conv1_1 to conv3_2 (M = 32 H W rows of
//               the im2col'd A, N = 64 to 256) their bytes, the A of 9 C
//               values a row and the int32 output of 4 bytes an element
//               (conv1_2 moves 925 MB of A and 411 MB of C, 0.399 ms, for
//               0.060 ms of operations); conv4_1 both about equally; conv4_2
//               and conv5_1 their operations; fc6 to fc8 (M = 32) reading the
//               weights, 103 MB at fc6.
//               Where TMA can describe the operands (K a multiple of 16,
//               both bases on 16 bytes; the caller decides, from the shape
//               alone): `gemmInt8Wgmma`.  For 8-bit types wgmma reads both
//               operands K-major (the transpose bits are f16 and bf16 only),
//               so B comes as B^T, the (N, K) table the engine lays out once
//               at build time.  A block owns BM = 64 or 128 rows (one or two
//               consumer warpgroups) by BN columns: all of N up to 256 on
//               128-row blocks, so that a tall conv product reads its rows of
//               A from device memory once and its B^T (at most 590 KB at
//               conv3_2) from L2; N = 512 takes two column blocks of one row
//               tile, next to each other in the grid's order, so that the
//               second finds the row tile in L2.  The rows with M = 32 (the
//               fc layers) take 64-row blocks of 128 columns and split-K.
//               A four-stage ring of 128-byte swizzled TMA boxes (A: BM rows
//               of 128 K values; B^T: BN rows of 128) with a full and an empty
//               mbarrier a stage and one producer thread, as gemmWgmma's; A's
//               descriptor serves both operands (K-major, SBO 1024), and a
//               stage is four m64nBNk32 products, each 32 bytes further into
//               the swizzle atom.  The int32 sums (BN / 2 registers a thread,
//               128 at BN = 256) go from the registers to device memory as
//               int2 pairs, masked at the ragged edge (single ints where N is
//               odd).  Row tiles and column blocks share the grid's first
//               axis (2^31 - 1 blocks), so no product is cut into chunks of
//               rows.  Split-K fills one wave of the blocks a ring lets an SM
//               hold, never more.  ptxas: 154 registers at 128 x 256, 90 at
//               128 x 128 and 64 x 128, 58 at 128 x 64 and 64 x 64, no
//               spill; 197,696 / 132,160 / 99,392 / 99,392 / 66,624 bytes of
//               dynamic shared memory (one, one, two, two, three blocks an
//               SM).  On an H100 80GB HBM3 at 700 W (chip_smoke.py
//               [K1-int8]) a request's 16 products take 1.89 ms against the
//               WMMA kernel's 8.82 and a bound of 1.37: 1.14-1.32x the bound
//               from conv1_2 to conv3_2; 2.0x at conv1_1, whose one stage of
//               32 K values a block leaves its 411 MB of stores unhidden;
//               1.7-2.1x from conv4_1 to conv5_1, where each stage's 48 KB
//               through L2 feeds 1 MOP of products (unmeasured: no ncu).
//               Otherwise (K off a multiple of 16, a base off 16 bytes):
//               `gemmInt8`, WMMA 16x16x16 s8 fragments with int32
//               accumulators; 64x64 block tile, BK = 64 (64 bytes a row, as
//               bf16's 32); the same cp.async ring and split-K.  WMMA wants
//               every 8-bit fragment on a 32-byte boundary, which a 16-byte K
//               step breaks in a row-major tile, so the shared tiles are kept
//               as 16-column slabs: A as [k / 16][m][16], B as [n / 16][k][16],
//               each fragment a contiguous 256-byte block.  Slabs are 1056
//               bytes apart (64 rows and two 16-byte chunks of padding), so
//               the 16-byte cp.async stores of one quarter-warp (two rows,
//               four slabs) fall into eight distinct bank groups.  Rows whose
//               K and N are multiples of 16 load as 16-byte vectors; other
//               shapes byte by byte.  It reads B as the (K, N) row-major
//               matrix.
//
// Entries: pl_matmul_splits(...) gives the number of K slices a shape takes
// on a kernel path (the caller allocates that many partial tiles of M x N
// when it is more than one: f32, or int32 for int8); pl_matmul(...) launches
// and returns the cudaError_t of cudaGetLastError().  The caller chooses the
// path, allocates C and owns the stream.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

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

// the kernel paths of pl_matmul: the tiled kernels with element or
// 16-byte loads, and the wgmma kernels (gemmWgmma for bf16 and f16,
// gemmInt8Wgmma for int8) with one or two consumer warpgroups
enum Path { PATH_TILED = 0, PATH_TILED_VEC = 1, PATH_WGMMA_64 = 2, PATH_WGMMA_128 = 3 };

constexpr int WBN = 128, WBK = 64;   // gemmWgmma's block columns and K step

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

// -- K1 on wgmma, fed by TMA (bf16, f16) ---------------------------------------

constexpr int WSTAGES = 4;
constexpr int W_A_BYTES = 64 * WBK * 2;   // a warpgroup's 64 rows of a K step: 64 rows of 128 bytes
constexpr int W_B_BOX = WBK * 64 * 2;     // a TMA box of B: 64 K rows of 64 columns (128 bytes)
constexpr int W_SWIZZLE = 1024;           // the 128-byte swizzle repeats every eight rows

// WG consumer warpgroups of 64 output rows each, and one producer warp
template <int WG>
struct Ring {
    static constexpr int BM = 64 * WG;
    static constexpr int THREADS = 128 * WG + 32;
    static constexpr int STAGE = WG * W_A_BYTES + 2 * W_B_BOX;
    // the stages, a full and an empty barrier each, and room to align the
    // stages to the swizzle's period
    static constexpr int SMEM = WSTAGES * STAGE + 2 * WSTAGES * 8 + W_SWIZZLE;
};

__device__ __forceinline__ uint32_t smemAddr(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// one box of `map` at (c0 along the rows, c1 across them) into dst, counted
// on bar; TMA writes zeros where the box leaves the matrix
__device__ __forceinline__ void tmaLoad(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar)
{
    asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smemAddr(dst)),
                 "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smemAddr(bar))
                 : "memory");
}

// a shared-memory matrix descriptor of a 128-byte swizzled tile: SBO 1024
// bytes (eight 128-byte rows) in both majors; LBO the distance between the
// 64-column halves of an MN-major B (unused for a K-major A)
__device__ __forceinline__ uint64_t swizzled(uint32_t addr, int lbo)
{
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(W_SWIZZLE >> 4) << 32) |
           (1ull << 62);
}

// d (+)= A B, m64n128k16, A K-major and B MN-major (transposed).  The first
// product of a sum starts it with accumulate = 0: no instruction outside
// wgmma defines the sum's registers, so ptxas leaves the products
// asynchronous
#define SUM_REGS \
    "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15," \
    "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31," \
    "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47," \
    "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}"
#define SUM_OPERANDS(d) \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
    "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
    "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
    "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
    "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

template <typename T>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da, uint64_t db, int accumulate)
{
    if constexpr (std::is_same<T, __half>::value)
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " SUM_REGS ", %64, %65, p, 1, 1, 0, 1;\n}\n"
                     : SUM_OPERANDS(d)
                     : "l"(da), "l"(db), "r"(accumulate));
    else
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SUM_REGS ", %64, %65, p, 1, 1, 0, 1;\n}\n"
                     : SUM_OPERANDS(d)
                     : "l"(da), "l"(db), "r"(accumulate));
}

#undef SUM_REGS
#undef SUM_OPERANDS

// ties the registers of a sum to this point of the program, so that the
// compiler neither reads them before the wait for the products nor moves
// their other uses across it
__device__ __forceinline__ void fenceSum(float (&acc)[64])
{
#pragma unroll
    for (int i = 0; i < 64; ++i)
        asm volatile("" : "+f"(acc[i])::"memory");
}

__device__ __forceinline__ __nv_bfloat162 pack(float x, float y, __nv_bfloat16)
{
    return __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ __half2 pack(float x, float y, __half)
{
    return __floats2half2_rn(x, y);
}

// one (BM x 128) output tile over K tiles [z * tilesPerSlice, (z + 1) *
// tilesPerSlice); with one slice the tile goes to C, else to partial[z] in
// f32.  Warps 0 .. 4 WG - 1 are the consumer warpgroups, warp 4 WG the
// producer.
template <typename T, int WG>
__global__ void __launch_bounds__(Ring<WG>::THREADS, 1)
gemmWgmma(const __grid_constant__ CUtensorMap mapA, const __grid_constant__ CUtensorMap mapB, T* __restrict__ C,
          float* __restrict__ partial, int M, int N, int K, int tilesPerSlice)
{
    using R = Ring<WG>;
    extern __shared__ __align__(128) unsigned char smemRaw[];
    unsigned char* smem = smemRaw + ((W_SWIZZLE - (smemAddr(smemRaw) & (W_SWIZZLE - 1))) & (W_SWIZZLE - 1));
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + WSTAGES * R::STAGE);
    uint64_t* empty = full + WSTAGES;

    const int tid = threadIdx.x;
    const int warp = __shfl_sync(0xFFFFFFFFu, tid >> 5, 0);
    const int m0 = blockIdx.y * R::BM, n0 = blockIdx.x * WBN;

    const int kTiles = (K + WBK - 1) / WBK;
    const int kt0 = blockIdx.z * tilesPerSlice;
    const int nt = max(min(kt0 + tilesPerSlice, kTiles) - kt0, 0);

    if (tid == 0) {
        for (int s = 0; s < WSTAGES; ++s) {
            barInit(&full[s], 1);
            barInit(&empty[s], 4 * WG);   // lane 0 of every consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == 4 * WG) {
        // the producer: one thread keeps the ring full.  A box of B wholly
        // right of N is not loaded: its columns reach no stored output
        if ((tid & 31) == 0) {
            const bool second = n0 + 64 < N;
            const unsigned bytes = WG * W_A_BYTES + (second ? 2 : 1) * W_B_BOX;
            for (int i = 0; i < nt; ++i) {
                const int s = i % WSTAGES;
                if (i >= WSTAGES)
                    barWait(&empty[s], (i / WSTAGES - 1) & 1);

                unsigned char* as = smem + s * R::STAGE;
                unsigned char* bs = as + WG * W_A_BYTES;
                const int k0 = (kt0 + i) * WBK;
                barExpect(&full[s], bytes);
                tmaLoad(as, &mapA, k0, m0, &full[s]);
                tmaLoad(bs, &mapB, n0, k0, &full[s]);
                if (second)
                    tmaLoad(bs + W_B_BOX, &mapB, n0 + 64, k0, &full[s]);
            }
        }
        return;
    }

    // a consumer warpgroup: rows 64 wg .. 64 wg + 63 of the tile
    const int wg = warp >> 2;
    float acc[64];   // set by its first product
    for (int i = 0; i < nt; ++i) {
        const int s = i % WSTAGES;
        barWait(&full[s], (i / WSTAGES) & 1);

        // A: the warpgroup's 64 rows of 128 bytes, k16 step kk 32 bytes on;
        // B: k16 step kk 16 rows of 128 bytes on, its second 64 columns one
        // box on (LBO)
        const uint32_t as = smemAddr(smem + s * R::STAGE) + wg * W_A_BYTES;
        const uint32_t bs = smemAddr(smem + s * R::STAGE + WG * W_A_BYTES);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < WBK / 16; ++kk)
            wgmma<T>(acc, swizzled(as + 32 * kk, 16), swizzled(bs + 16 * 128 * kk, W_B_BOX), i > 0 || kk > 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");

        // step i - 1's products have retired: its stage is free
        if (i > 0 && (tid & 31) == 0)
            barArrive(&empty[(i - 1) % WSTAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fenceSum(acc);

    // thread (warp w of its warpgroup, lane l) holds rows 16 w + l / 4 (h = 0)
    // and + 8 (h = 1), columns 8 j + 2 (l % 4) and + 1: acc[4 j + 2 h], + 1.
    // N is a multiple of 8, so a pair is wholly inside or outside
    using Pair = decltype(pack(0.0f, 0.0f, T()));
    const int w = warp & 3, l = tid & 31;
    float* out = partial + (size_t)blockIdx.z * M * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int gm = m0 + 64 * wg + 16 * w + l / 4 + 8 * h;
        if (gm >= M)
            continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int gn = n0 + 8 * j + 2 * (l & 3);
            if (gn >= N)
                continue;
            const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
            if (gridDim.z == 1)
                *reinterpret_cast<Pair*>(C + (size_t)gm * N + gn) = pack(x, y, T());
            else
                *reinterpret_cast<float2*>(out + (size_t)gm * N + gn) = make_float2(x, y);
        }
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

// a row-major (rows, cols) matrix of `bytes`-byte values of `type` as TMA
// reads it: boxes of boxRows rows of 128 bytes (64 columns of 16 bits, 128
// of 8), 128-byte swizzled, zeros outside the matrix
bool tensorMap(CUtensorMap* map, const void* base, int rows, int cols, int boxRows, CUtensorMapDataType type,
               int bytes)
{
    static const EncodeTiled encode = findEncoder();
    if (encode == nullptr)
        return false;

    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * bytes};
    const cuuint32_t box[2] = {(cuuint32_t)(128 / bytes), (cuuint32_t)boxRows};
    const cuuint32_t steps[2] = {1, 1};
    return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int WG>
cudaError_t launchWgmma(const void* a, const void* b, void* c, float* partial, int m, int n, int k, int slices,
                        int tilesPerSlice, cudaStream_t stream)
{
    using R = Ring<WG>;
    const CUtensorMapDataType type =
        std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

    CUtensorMap mapA, mapB;
    if (!tensorMap(&mapA, a, m, k, R::BM, type, 2) || !tensorMap(&mapB, b, k, n, WBK, type, 2))
        return cudaErrorInvalidValue;

    const cudaError_t err = cudaFuncSetAttribute(gemmWgmma<T, WG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 R::SMEM);
    if (err != cudaSuccess)
        return err;

    const dim3 grid((n + WBN - 1) / WBN, (m + R::BM - 1) / R::BM, slices);
    gemmWgmma<T, WG><<<grid, R::THREADS, R::SMEM, stream>>>(mapA, mapB, static_cast<T*>(c), partial, m, n, k,
                                                            tilesPerSlice);
    if (slices > 1)
        sumSlices<float, T><<<512, 256, 0, stream>>>(partial, static_cast<T*>(c), (long long)m * n, slices);

    return cudaSuccess;
}

template <typename T>
cudaError_t launchFloat16(const void* a, const void* b, void* c, float* partial, int m, int n, int k, int path,
                          int slices, int tilesPerSlice, cudaStream_t stream)
{
    switch (path) {
    case PATH_TILED:
    case PATH_TILED_VEC:
        launchTensorCore<T>(a, b, c, partial, m, n, k, path == PATH_TILED_VEC, slices, tilesPerSlice, stream);
        return cudaSuccess;
    case PATH_WGMMA_64:
        return launchWgmma<T, 1>(a, b, c, partial, m, n, k, slices, tilesPerSlice, stream);
    case PATH_WGMMA_128:
        return launchWgmma<T, 2>(a, b, c, partial, m, n, k, slices, tilesPerSlice, stream);
    default:
        return cudaErrorInvalidValue;
    }
}

// -- K1-int8 on wgmma, fed by TMA -----------------------------------------------

constexpr int I8_BK = 128;             // K values a stage: one 128-byte swizzle row of A and of B^T
constexpr int I8_STAGES = 4;
constexpr int SM_SMEM = 233472;        // an SM's shared memory, of which each resident block also takes 1 KB

// the shared memory of an int8 ring of wg warpgroups by bn columns (the
// stages, their full and empty mbarriers, the swizzle's alignment slack),
// and the blocks of it that fit an SM
__host__ __device__ constexpr int int8RingSmem(int wg, int bn)
{
    return I8_STAGES * (64 * wg + bn) * I8_BK + 2 * I8_STAGES * 8 + W_SWIZZLE;
}

__host__ __device__ constexpr int int8PerSm(int wg, int bn)
{
    return SM_SMEM / (int8RingSmem(wg, bn) + 1024);
}

// WG consumer warpgroups of 64 output rows each, one producer warp, BN
// output columns
template <int WG, int BN>
struct Int8Ring {
    static constexpr int BM = 64 * WG;
    static constexpr int THREADS = 128 * WG + 32;
    static constexpr int A_BYTES = BM * I8_BK;
    static constexpr int STAGE = A_BYTES + BN * I8_BK;
    static constexpr int SMEM = int8RingSmem(WG, BN);
    static constexpr int PER_SM = int8PerSm(WG, BN);
};

// the block columns of an int8 product of n columns on WG warpgroups: all of
// n up to 256 (128 on one warpgroup, whose rows are few), so that a tall
// product reads its rows of A from device memory once
inline int int8Bn(int n, int wg)
{
    return n <= 64 ? 64 : (n <= 128 || wg == 1) ? 128 : 256;
}

#define I8_SUM8(d, b) \
    "+r"(d[b]), "+r"(d[b + 1]), "+r"(d[b + 2]), "+r"(d[b + 3]), "+r"(d[b + 4]), "+r"(d[b + 5]), "+r"(d[b + 6]), \
    "+r"(d[b + 7])
#define I8_SUM32(d) I8_SUM8(d, 0), I8_SUM8(d, 8), I8_SUM8(d, 16), I8_SUM8(d, 24)
#define I8_SUM64(d) I8_SUM32(d), I8_SUM8(d, 32), I8_SUM8(d, 40), I8_SUM8(d, 48), I8_SUM8(d, 56)
#define I8_SUM128(d) \
    I8_SUM64(d), I8_SUM8(d, 64), I8_SUM8(d, 72), I8_SUM8(d, 80), I8_SUM8(d, 88), I8_SUM8(d, 96), I8_SUM8(d, 104), \
    I8_SUM8(d, 112), I8_SUM8(d, 120)

// d (+)= A B^T, m64nBNk32 in int8 with int32 sums, A and B^T both K-major
// (wgmma reads 8-bit operands K-major only).  As for bf16, the first product
// of a sum starts it with accumulate = 0
template <int BN>
__device__ __forceinline__ void wgmmaInt8(int (&d)[BN / 2], uint64_t da, uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void wgmmaInt8<64>(int (&d)[32], uint64_t da, uint64_t db, int accumulate)
{
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
                 "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
                 "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}"
                 ", %32, %33, p;\n}\n"
                 : I8_SUM32(d)
                 : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmmaInt8<128>(int (&d)[64], uint64_t da, uint64_t db, int accumulate)
{
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
                 "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
                 "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
                 "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
                 "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}"
                 ", %64, %65, p;\n}\n"
                 : I8_SUM64(d)
                 : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmmaInt8<256>(int (&d)[128], uint64_t da, uint64_t db, int accumulate)
{
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
                 "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
                 "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
                 "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
                 "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
                 "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
                 "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
                 "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
                 "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127}"
                 ", %128, %129, p;\n}\n"
                 : I8_SUM128(d)
                 : "l"(da), "l"(db), "r"(accumulate));
}

#undef I8_SUM8
#undef I8_SUM32
#undef I8_SUM64
#undef I8_SUM128

template <int R>
__device__ __forceinline__ void fenceSum(int (&acc)[R])
{
#pragma unroll
    for (int i = 0; i < R; ++i)
        asm volatile("" : "+r"(acc[i])::"memory");
}

// one (BM x BN) int32 output tile of A (M, K) @ B^T (N, K)^T over K tiles [y
// tilesPerSlice, (y + 1) tilesPerSlice), y = blockIdx.y; with one slice the
// tile goes to C, else to partial[y].  blockIdx.x walks the column blocks of
// one row tile before the next row tile, so that the blocks that share a row
// tile of A run side by side and the later ones find it in L2.  Warps 0 ..
// 4 WG - 1 are the consumer warpgroups, warp 4 WG the producer.
template <int WG, int BN>
__global__ void __launch_bounds__(Int8Ring<WG, BN>::THREADS, Int8Ring<WG, BN>::PER_SM)
gemmInt8Wgmma(const __grid_constant__ CUtensorMap mapA, const __grid_constant__ CUtensorMap mapB,
              int* __restrict__ C, int* __restrict__ partial, int M, int N, int K, int colBlocks, int tilesPerSlice)
{
    using R = Int8Ring<WG, BN>;
    extern __shared__ __align__(128) unsigned char smemRaw[];
    unsigned char* smem = smemRaw + ((W_SWIZZLE - (smemAddr(smemRaw) & (W_SWIZZLE - 1))) & (W_SWIZZLE - 1));
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + I8_STAGES * R::STAGE);
    uint64_t* empty = full + I8_STAGES;

    const int tid = threadIdx.x;
    const int warp = __shfl_sync(0xFFFFFFFFu, tid >> 5, 0);
    const int m0 = (blockIdx.x / colBlocks) * R::BM, n0 = (blockIdx.x % colBlocks) * BN;

    const int kTiles = (K + I8_BK - 1) / I8_BK;
    const int kt0 = blockIdx.y * tilesPerSlice;
    const int nt = max(min(kt0 + tilesPerSlice, kTiles) - kt0, 0);

    if (tid == 0) {
        for (int s = 0; s < I8_STAGES; ++s) {
            barInit(&full[s], 1);
            barInit(&empty[s], 4 * WG);   // lane 0 of every consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == 4 * WG) {
        // the producer: one thread keeps the ring full, a box of A (BM rows
        // of 128 K values) and one of B^T (BN rows) a stage.  TMA counts the
        // whole boxes, the zeros it writes outside the matrices included
        if ((tid & 31) == 0) {
            for (int i = 0; i < nt; ++i) {
                const int s = i % I8_STAGES;
                if (i >= I8_STAGES)
                    barWait(&empty[s], (i / I8_STAGES - 1) & 1);

                unsigned char* as = smem + s * R::STAGE;
                const int k0 = (kt0 + i) * I8_BK;
                barExpect(&full[s], R::STAGE);
                tmaLoad(as, &mapA, k0, m0, &full[s]);
                tmaLoad(as + R::A_BYTES, &mapB, k0, n0, &full[s]);
            }
        }
        return;
    }

    // a consumer warpgroup: rows 64 wg .. 64 wg + 63 of the tile, four k32
    // products a stage, each 32 bytes further into the 128-byte rows of A and
    // B^T; one group in flight
    const int wg = warp >> 2;
    int acc[BN / 2];   // set by its first product
    for (int i = 0; i < nt; ++i) {
        const int s = i % I8_STAGES;
        barWait(&full[s], (i / I8_STAGES) & 1);

        const uint32_t as = smemAddr(smem + s * R::STAGE) + wg * 64 * I8_BK;
        const uint32_t bs = smemAddr(smem + s * R::STAGE + R::A_BYTES);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < I8_BK / 32; ++kk)
            wgmmaInt8<BN>(acc, swizzled(as + 32 * kk, 16), swizzled(bs + 32 * kk, 16), i > 0 || kk > 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");

        // step i - 1's products have retired: its stage is free
        if (i > 0 && (tid & 31) == 0)
            barArrive(&empty[(i - 1) % I8_STAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fenceSum(acc);

    // thread (warp w of its warpgroup, lane l) holds rows 16 w + l / 4 (h = 0)
    // and + 8 (h = 1), columns 8 j + 2 (l % 4) and + 1: acc[4 j + 2 h], + 1.
    // With N even a pair is wholly inside or outside and lands on 8 bytes
    const int w = warp & 3, l = tid & 31;
    int* out = gridDim.y == 1 ? C : partial + (size_t)blockIdx.y * M * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int gm = m0 + 64 * wg + 16 * w + l / 4 + 8 * h;
        if (gm >= M)
            continue;
        int* row = out + (size_t)gm * N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            const int gn = n0 + 8 * j + 2 * (l & 3);
            const int x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
            if ((N & 1) == 0) {
                if (gn < N)
                    *reinterpret_cast<int2*>(row + gn) = make_int2(x, y);
            } else {
                if (gn < N)
                    row[gn] = x;
                if (gn + 1 < N)
                    row[gn + 1] = y;
            }
        }
    }
}

template <int WG, int BN>
cudaError_t launchInt8Wgmma(const void* a, const void* bt, int* c, int* partial, int m, int n, int k, int slices,
                            int tilesPerSlice, cudaStream_t stream)
{
    using R = Int8Ring<WG, BN>;

    CUtensorMap mapA, mapB;
    if (!tensorMap(&mapA, a, m, k, R::BM, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1) ||
        !tensorMap(&mapB, bt, n, k, BN, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1))
        return cudaErrorInvalidValue;

    const cudaError_t err = cudaFuncSetAttribute(gemmInt8Wgmma<WG, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 R::SMEM);
    if (err != cudaSuccess)
        return err;

    // the row tiles and their column blocks on the grid's first axis, which
    // holds 2^31 - 1 blocks: conv1_x's 1.6 M rows need no chunks
    const int colBlocks = (n + BN - 1) / BN;
    const long long blocks = (long long)((m + R::BM - 1) / R::BM) * colBlocks;
    if (blocks > 0x7FFFFFFFLL)
        return cudaErrorInvalidValue;

    gemmInt8Wgmma<WG, BN><<<dim3((unsigned)blocks, slices), R::THREADS, R::SMEM, stream>>>(
        mapA, mapB, c, partial, m, n, k, colBlocks, tilesPerSlice);
    if (slices > 1)
        sumSlices<int, int><<<512, 256, 0, stream>>>(partial, c, (long long)m * n, slices);

    return cudaSuccess;
}

// the tile of a product of n columns of type `dtype` on kernel path `path`:
// block rows, columns and K step, and the blocks an SM holds (two, the
// target of the float paths' split-K; for int8 on wgmma those its ring fits)
void tileShape(int dtype, int path, int n, int* bm, int* bn, int* bk, int* perSm)
{
    *perSm = 2;
    if (path == PATH_WGMMA_64 || path == PATH_WGMMA_128) {
        const int wg = path == PATH_WGMMA_64 ? 1 : 2;
        *bm = 64 * wg;
        if (dtype != 3) {
            *bn = WBN; *bk = WBK;
            return;
        }
        *bn = int8Bn(n, wg); *bk = I8_BK;
        *perSm = int8PerSm(wg, *bn);
        return;
    }

    switch (dtype) {
    case 0:  *bm = SBM; *bn = SBN; *bk = SBK; break;
    case 3:  *bm = IBM; *bn = IBN; *bk = IBK; break;
    default: *bm = HBM; *bn = HBN; *bk = HBK; break;
    }
}

cudaError_t launchInt8(const void* a, const void* b, void* c, void* partial, int m, int n, int k, int path, int slices,
                       int tilesPerSlice, cudaStream_t stream)
{
    const int8_t* A = static_cast<const int8_t*>(a);
    const int8_t* B = static_cast<const int8_t*>(b);
    int* C = static_cast<int*>(c);
    int* part = static_cast<int*>(partial);

    switch (path) {
    case PATH_TILED:
    case PATH_TILED_VEC: {
        const dim3 grid((n + IBN - 1) / IBN, (m + IBM - 1) / IBM, slices);
        if (path == PATH_TILED_VEC)
            gemmInt8<true><<<grid, HTHREADS, 0, stream>>>(A, B, C, part, m, n, k, tilesPerSlice);
        else
            gemmInt8<false><<<grid, HTHREADS, 0, stream>>>(A, B, C, part, m, n, k, tilesPerSlice);
        if (slices > 1)
            sumSlices<int, int><<<512, 256, 0, stream>>>(part, C, (long long)m * n, slices);
        return cudaSuccess;
    }
    case PATH_WGMMA_64:
        if (int8Bn(n, 1) == 64)
            return launchInt8Wgmma<1, 64>(a, b, C, part, m, n, k, slices, tilesPerSlice, stream);
        return launchInt8Wgmma<1, 128>(a, b, C, part, m, n, k, slices, tilesPerSlice, stream);
    case PATH_WGMMA_128:
        switch (int8Bn(n, 2)) {
        case 64:
            return launchInt8Wgmma<2, 64>(a, b, C, part, m, n, k, slices, tilesPerSlice, stream);
        case 128:
            return launchInt8Wgmma<2, 128>(a, b, C, part, m, n, k, slices, tilesPerSlice, stream);
        default:
            return launchInt8Wgmma<2, 256>(a, b, C, part, m, n, k, slices, tilesPerSlice, stream);
        }
    default:
        return cudaErrorInvalidValue;
    }
}

}  // namespace

// The number of K slices for an (m, k) @ (k, n) product of type `dtype` on
// kernel path `path` on a card with `sms` SMs: one when the output tiles
// fill the SMs (two blocks each; for int8 on wgmma the blocks its ring lets
// an SM hold), else enough to reach that, with at least MIN_TILES_PER_SLICE
// K tiles each.
extern "C" int pl_matmul_splits(int m, int n, int k, int dtype, int path, int sms)
{
    const bool int8Wgmma = dtype == 3 && (path == PATH_WGMMA_64 || path == PATH_WGMMA_128);
    int bm, bn, bk, perSm;
    tileShape(dtype, path, n, &bm, &bn, &bk, &perSm);

    const long long blocks = (long long)((m + bm - 1) / bm) * ((n + bn - 1) / bn);
    const int kTiles = (k + bk - 1) / bk;

    if (blocks >= (long long)perSm * sms || kTiles < 2 * MIN_TILES_PER_SLICE)
        return 1;

    // the float paths round the slices up to two blocks an SM; int8 on wgmma
    // down to one wave of the blocks its ring lets an SM hold, since a second
    // wave of slices adds partial tiles and no SM
    int slices = int8Wgmma ? (int)((long long)perSm * sms / blocks) : (int)((2LL * sms + blocks - 1) / blocks);
    if (slices > kTiles / MIN_TILES_PER_SLICE)
        slices = kTiles / MIN_TILES_PER_SLICE;
    if (slices <= 1)
        return 1;

    const int perSlice = (kTiles + slices - 1) / slices;
    return (kTiles + perSlice - 1) / perSlice;
}

// dtype: 0 = f32, 1 = bf16, 2 = f16, 3 = int8 (C in int32).  path (Path):
// PATH_TILED_VEC where the caller has checked that A and B start on 16-byte
// boundaries and that K and N are multiples of 8 (16 for int8), one 16-byte
// vector; PATH_WGMMA_64 or PATH_WGMMA_128 for bf16 and f16 under the same
// checks with K and N multiples of 8, M, N and K above 0, and for int8 with
// K a multiple of 16, both bases on 16 bytes and M, N and K above 0, where
// `b` is B^T, the (n, k) row-major table (wgmma reads 8-bit operands
// K-major only); PATH_TILED for any shape.  f32 takes its one kernel on
// either tiled path.  partial: `slices` tiles of m x n, f32 (int32 for
// int8), used when slices > 1.
extern "C" int pl_matmul(const void* a, const void* b, void* c, void* partial, int m, int n, int k,
                         int dtype, int path, int slices, void* stream)
{
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* part = static_cast<float*>(partial);

    if (slices < 1 || (slices > 1 && part == nullptr) || path < PATH_TILED || path > PATH_WGMMA_128 ||
        (path >= PATH_WGMMA_64 && dtype == 0))
        return static_cast<int>(cudaErrorInvalidValue);

    int bm, bn, bk, perSm;
    tileShape(dtype, path, n, &bm, &bn, &bk, &perSm);
    const int kTiles = (k + bk - 1) / bk;
    const int tilesPerSlice = (kTiles + slices - 1) / slices;

    cudaError_t err = cudaSuccess;
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
        err = launchFloat16<__nv_bfloat16>(a, b, c, part, m, n, k, path, slices, tilesPerSlice, s);
        break;
    case 2:
        err = launchFloat16<__half>(a, b, c, part, m, n, k, path, slices, tilesPerSlice, s);
        break;
    case 3:
        err = launchInt8(a, b, c, partial, m, n, k, path, slices, tilesPerSlice, s);
        break;
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }

    if (err != cudaSuccess)
        return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
