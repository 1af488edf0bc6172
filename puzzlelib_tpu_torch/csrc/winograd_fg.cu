// Winograd F(2x2, 3x3) backward-filter in the transform domain for Hopper
// (sm_90a), bf16 in, f32 out.
//
// Replaces the Pallas TPU kernel puzzlelib_tpu/ops/pallas/winograd.py
// `_fgKernel` (wrappers `_winogradFG`, `filterGradNHWC`).  The filter gradient
// of the 3x3 stride-1 conv, taken before the filter transform, is
//
//     dU[xi nu] = sum over 2x2 output tiles of  V[xi nu]^T Mbar[xi nu],
//
// where V = B^T d B is the 4x4 input patch of a tile (as in the forward) and
// Mbar = A dY A^T its 2x2 gradient tile (no halo).  Each of the 16 products is
// a GEMM with M = C, N = CO and K = the number of tiles; dW = G^T dU G is left
// to the caller (a (9, 16) product, plain torch, as the reference leaves it to
// XLA).
//
// Rounding points, those of the reference kernel:
//   - V: each butterfly stage of B^T d B is rounded to bf16 (packed bf16
//     adds; the reference keeps `t1` in the input's type);
//   - Mbar: the signed dY terms are summed in bf16 in the order of the
//     reference's `_ACOL[xi] x _ACOL[nu]` loops;
//   - the 16 products are accumulated in f32 over tiles.
//
// What the TPU version had to fight and this one does not: the row-phase
// slabs, the lane interleave and the zero-padded dY that nulls the slabs'
// garbage columns.  Here a block reads 4x4 patches of x and 2x2 patches of dY
// straight from NHWC with bounds checks; the conv's zero padding, the odd-size
// crop and the partial last tile are all the same mask.
//
// Blocking: one block per (BM = 32 input channels) x (BN = 64 output
// channels) x (a chunk of tiles), 16 warps, one (xi, nu) GEMM per warp with its
// 32 x 64 f32 sum in 2 x 4 WMMA 16x16x16 fragments.  The tile axis is long
// (100,352 tiles for VGG-16's conv2_2 at batch 32) and the output small
// (16 x C x CO), so the tiles are split across blocks (grid z) and each split
// writes its own f32 partial; `sumPartials` then adds the partials in split
// order, so the gradient is deterministic (no atomics).  Per step of BK = 32
// tiles each thread loads the 4x4 patch of one tile for two neighbouring
// channels and the 2x2 gradient patch of the same tile for two pairs of output
// channels into registers while the tensor cores run the previous step, then
// transforms them into V (16 x BK x BM) and Mbar (16 x BK x BN) in shared
// memory.
//
// What bounds it on the H100: the transforms and the traffic into shared
// memory, not the tensor cores.  The 16 GEMMs of conv2_2 at batch 32 are 52.6
// GFLOP; every x patch is loaded once per block of output channels (CO / 64
// times) and every dY patch once per block of input channels (C / 32 times),
// and a step's WMMA work (16 x 32 x 64 x 32) is small against its 48 KB of
// bf16 transform work.  Still to come: wgmma on larger tiles and TMA loads.
//
// Entry: pl_winograd_fg(...) returns the cudaError_t of cudaGetLastError()
// after the launches.  x is NHWC (N, H, W, C) bf16, dy is NHWC (N, OH, OW, CO)
// bf16 with OH = H + 2 padH - 2, du is (16, C, CO) f32, all contiguous; C a
// multiple of 32, CO of 64.  `chunk` tiles per split (a multiple of BK); with
// more than one split, `work` holds splits x 16 x C x CO f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 32;        // input channels per block: the M of each GEMM
constexpr int BN = 64;        // output channels per block: the N
constexpr int BK = 32;        // tiles per step: the K chunk
constexpr int THREADS = 512;  // 16 warps, one (xi, nu) each

constexpr int LDV = BM + 8;   // bf16 row pitches: multiples of 8 for WMMA
constexpr int LDM = BN + 8;

constexpr int V_BYTES = 16 * BK * LDV * 2;
constexpr int M_BYTES = 16 * BK * LDM * 2;
constexpr int SMEM_BYTES = V_BYTES + M_BYTES;

static_assert(BK * (BM / 2) == THREADS, "one (tile, channel pair) of V per thread and step");
static_assert(BK * (BN / 4) == THREADS, "one tile and two output-channel pairs of Mbar per thread and step");
static_assert(SMEM_BYTES <= 227 * 1024, "a block's shared memory on the H100");

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

// where this thread's tile of a step lies: the offsets of its x patch corner
// and dY patch corner, and which of their positions lie inside the tensors
struct TilePos {
    long long xbase, ybase;
    unsigned xin, yin;
};

__device__ __forceinline__ TilePos locate(long long t, long long tEnd, int H, int W, int C, int OH, int OW,
                                          int CO, int padH, int padW, int TH, int TW, int cx, int cy)
{
    TilePos p = {0, 0, 0u, 0u};
    if (t >= tEnd)
        return p;

    const int n = (int)(t / (TH * TW));
    const int rem = (int)(t % (TH * TW));
    const int i = rem / TW, j = rem % TW;

    const int h0 = 2 * i - padH, w0 = 2 * j - padW;
    p.xbase = (((long long)n * H + h0) * W + w0) * C + cx;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s)
            if (h0 + r >= 0 && h0 + r < H && w0 + s >= 0 && w0 + s < W)
                p.xin |= 1u << (4 * r + s);

    p.ybase = (((long long)n * OH + 2 * i) * OW + 2 * j) * CO + cy;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
            if (2 * i + a < OH && 2 * j + b < OW)
                p.yin |= 1u << (2 * a + b);

    return p;
}

// the 4x4 x patch at one channel pair and the 2x2 dY patch at two output
// channel pairs (cy and cy + BN / 2), zero outside the tensors
__device__ __forceinline__ void loadStep(bf162 (&d)[4][4], bf162 (&g)[2][2][2], const bf16* __restrict__ x,
                                         const bf16* __restrict__ dy, const TilePos& p, int W, int OW, int C,
                                         int CO)
{
    const bf162 zero = __floats2bfloat162_rn(0.0f, 0.0f);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s)
            d[r][s] = (p.xin >> (4 * r + s)) & 1u
                ? *reinterpret_cast<const bf162*>(x + (p.xbase + ((long long)r * W + s) * C)) : zero;

#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b)
                g[q][a][b] = (p.yin >> (2 * a + b)) & 1u
                    ? *reinterpret_cast<const bf162*>(dy + (p.ybase + ((long long)a * OW + b) * CO + q * (BN / 2)))
                    : zero;
}

// B^T = ((1, 0, -1, 0), (0, 1, 1, 0), (0, -1, 1, 0), (0, 1, 0, -1)) on four values
__device__ __forceinline__ void butterfly(bf162& d0, bf162& d1, bf162& d2, bf162& d3)
{
    const bf162 t0 = __hsub2(d0, d2), t1 = __hadd2(d1, d2), t2 = __hsub2(d2, d1), t3 = __hsub2(d1, d3);
    d0 = t0; d1 = t1; d2 = t2; d3 = t3;
}

// V = B^T d B of one patch, rows then columns, each stage rounded to bf16 ->
// its 16 rows of Vs (row = tile, columns = channels: the col-major A of V^T)
__device__ __forceinline__ void storeV(bf16* Vs, bf162 (&d)[4][4], int tl, int cp)
{
#pragma unroll
    for (int s = 0; s < 4; ++s)
        butterfly(d[0][s], d[1][s], d[2][s], d[3][s]);
#pragma unroll
    for (int r = 0; r < 4; ++r)
        butterfly(d[r][0], d[r][1], d[r][2], d[r][3]);

#pragma unroll
    for (int xi = 0; xi < 4; ++xi)
#pragma unroll
        for (int nu = 0; nu < 4; ++nu)
            *reinterpret_cast<bf162*>(Vs + ((xi * 4 + nu) * BK + tl) * LDV + 2 * cp) = d[xi][nu];
}

// Mbar[xi nu] = sum of sign * dY[a][b] over the nonzero entries of A^T's
// columns xi (rows a) and nu (columns b), A^T = ((1, 1, 1, 0), (0, 1, -1, -1)):
// column 0 is +row 0, 1 is +row 0 +row 1, 2 is +row 0 -row 1, 3 is -row 1.
// Summed left to right in bf16, a outer and b inner, as the reference does ->
// its 16 rows of Ms (row = tile, columns = output channels: the row-major B)
__device__ __forceinline__ void storeMbar(bf16* Ms, const bf162 (&g)[2][2], int tl, int col)
{
    const bf162 d00 = g[0][0], d01 = g[0][1], d10 = g[1][0], d11 = g[1][1];
    const bf162 m[4][4] = {
        {d00, __hadd2(d00, d01), __hsub2(d00, d01), __hneg2(d01)},
        {__hadd2(d00, d10), __hadd2(__hadd2(__hadd2(d00, d01), d10), d11),
         __hsub2(__hadd2(__hsub2(d00, d01), d10), d11), __hsub2(__hneg2(d01), d11)},
        {__hsub2(d00, d10), __hsub2(__hsub2(__hadd2(d00, d01), d10), d11),
         __hadd2(__hsub2(__hsub2(d00, d01), d10), d11), __hadd2(__hneg2(d01), d11)},
        {__hneg2(d10), __hsub2(__hneg2(d10), d11), __hadd2(__hneg2(d10), d11), d11},
    };

#pragma unroll
    for (int xi = 0; xi < 4; ++xi)
#pragma unroll
        for (int nu = 0; nu < 4; ++nu)
            *reinterpret_cast<bf162*>(Ms + ((xi * 4 + nu) * BK + tl) * LDM + col) = m[xi][nu];
}

__device__ __forceinline__ void storeStep(bf16* Vs, bf16* Ms, bf162 (&d)[4][4], const bf162 (&g)[2][2][2],
                                          int tl, int cp)
{
    storeV(Vs, d, tl, cp);
    storeMbar(Ms, g[0], tl, 2 * cp);
    storeMbar(Ms, g[1], tl, BN / 2 + 2 * cp);
}

__global__ void __launch_bounds__(THREADS, 1)
winogradFG(const bf16* __restrict__ x, const bf16* __restrict__ dy, float* __restrict__ out,
           int H, int W, int C, int CO, int OH, int OW, int padH, int padW, int TH, int TW,
           long long tiles, long long chunk)
{
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* Vs = reinterpret_cast<bf16*>(smem);
    bf16* Ms = reinterpret_cast<bf16*>(smem + V_BYTES);

    const int tid = threadIdx.x;
    const int xinu = tid >> 5;   // this warp's transform-domain GEMM
    const int co0 = blockIdx.x * BN, c0 = blockIdx.y * BM;

    const long long tBeg = (long long)blockIdx.z * chunk;
    const long long tEnd = tBeg + chunk < tiles ? tBeg + chunk : tiles;
    const int steps = (int)((tEnd - tBeg + BK - 1) / BK);

    // this thread's tile of each step, its input channel pair for V and its
    // two output channel pairs for Mbar
    const int tl = tid / (BM / 2), cp = tid % (BM / 2);

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            wmma::fill_fragment(acc[i][j], 0.0f);

    bf162 d[4][4], g[2][2][2];
    {
        const TilePos p = locate(tBeg + tl, tEnd, H, W, C, OH, OW, CO, padH, padW, TH, TW,
                                 c0 + 2 * cp, co0 + 2 * cp);
        loadStep(d, g, x, dy, p, W, OW, C, CO);
        storeStep(Vs, Ms, d, g, tl, cp);
    }

    // step i: the loads of step i + 1 are in flight in registers while the
    // tensor cores run step i; they are transformed into shared memory once
    // every warp is done reading it
    for (int i = 0; i < steps; ++i) {
        const bool more = i + 1 < steps;
        if (more) {
            const TilePos p = locate(tBeg + (long long)(i + 1) * BK + tl, tEnd, H, W, C, OH, OW, CO, padH, padW,
                                     TH, TW, c0 + 2 * cp, co0 + 2 * cp);
            loadStep(d, g, x, dy, p, W, OW, C, CO);
        }
        __syncthreads();   // step i's V and Mbar are in shared memory

        const bf16* Vb = Vs + xinu * BK * LDV;
        const bf16* Mb = Ms + xinu * BK * LDM;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            // A = V^T (channels x tiles), stored tile-major: col-major
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
#pragma unroll
            for (int r = 0; r < 2; ++r)
                wmma::load_matrix_sync(a[r], Vb + kk * LDV + r * 16, LDV);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
                wmma::load_matrix_sync(b, Mb + kk * LDM + j * 16, LDM);
#pragma unroll
                for (int r = 0; r < 2; ++r)
                    wmma::mma_sync(acc[r][j], a[r], b, acc[r][j]);
            }
        }
        __syncthreads();   // every warp is done with V and Mbar

        if (more)
            storeStep(Vs, Ms, d, g, tl, cp);
    }

    // this split's dU[xinu][c0:c0+32][co0:co0+64]
    float* o = out + (size_t)blockIdx.z * 16 * C * CO;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            wmma::store_matrix_sync(o + ((size_t)xinu * C + c0 + r * 16) * CO + co0 + j * 16, acc[r][j], CO,
                                    wmma::mem_row_major);
}

// out = the sum of the splits' partials, added in split order
__global__ void sumPartials(const float4* __restrict__ part, float4* __restrict__ out, int splits, long long n4)
{
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
         i += (long long)gridDim.x * blockDim.x) {
        float4 s = part[i];
        for (int k = 1; k < splits; ++k) {
            const float4 p = part[(long long)k * n4 + i];
            s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
        }
        out[i] = s;
    }
}

}  // namespace

extern "C" int pl_winograd_fg(const void* x, const void* dy, void* du, void* work,
                              int n, int h, int w, int c, int co, int padH, int padW, long long chunk,
                              void* stream)
{
    const int oh = h + 2 * padH - 2, ow = w + 2 * padW - 2;
    if (n <= 0 || c <= 0 || c % BM != 0 || co <= 0 || co % BN != 0 || oh <= 0 || ow <= 0)
        return static_cast<int>(cudaErrorInvalidValue);

    const int th = (oh + 1) / 2, tw = (ow + 1) / 2;
    const long long tiles = (long long)n * th * tw;
    if (chunk <= 0 || chunk % BK != 0)
        return static_cast<int>(cudaErrorInvalidValue);

    const long long splits = (tiles + chunk - 1) / chunk;
    if (splits > 65535 || (splits > 1 && work == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);

    cudaError_t err = cudaFuncSetAttribute(winogradFG, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess)
        return static_cast<int>(err);

    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* partials = splits > 1 ? static_cast<float*>(work) : static_cast<float*>(du);

    const dim3 grid(co / BN, c / BM, (unsigned)splits);
    winogradFG<<<grid, THREADS, SMEM_BYTES, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dy), partials,
        h, w, c, co, oh, ow, padH, padW, th, tw, tiles, chunk);

    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1)
        return static_cast<int>(err);

    const long long n4 = 4LL * c * co;   // 16 * c * co / 4 float4s
    const long long blocks = (n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096;
    sumPartials<<<(unsigned)blocks, 256, 0, s>>>(static_cast<const float4*>(work), static_cast<float4*>(du),
                                                 (int)splits, n4);

    return static_cast<int>(cudaGetLastError());
}
