// Fused Winograd F(2x2, 3x3) forward convolution for Hopper (sm_90a), bf16.
//
// Replaces the Pallas TPU kernel puzzlelib_tpu/ops/pallas/winograd.py `_kernel`
// (wrappers `_winogradHC`, `conv2dNHWC`, `conv2d`).  Each 4x4 input patch
// (stride 2) gives one 2x2 output tile through
//
//     Y = A^T [ U . (B^T d B) ] A,      U = G g G^T (computed by the caller),
//
// with the elementwise product over channels done as 16 GEMMs of depth C, one
// per transform-domain position (xi, nu): 2.25x fewer multiplies than the
// direct conv.  As on the TPU, the whole pipeline is one kernel, so the 16x
// transform-domain tensor (4x the input) never goes to device memory.
//
// What the TPU version had to fight and this one does not: VMEM-sized blocks,
// the (8, 128) tiled layout that forced row-phase slabs and lane interleave,
// and the sequential grid that carried the accumulator.  Here a block reads
// its 4x4 patches straight from the NHWC input with bounds checks (the zero
// padding of the conv is the check), and keeps the 16 accumulators of its
// tile block in tensor-core fragments across the whole channel loop.
//
// What bounds it on the H100: not the tensor cores.  The 16 GEMMs are cheap
// (52.6 GFLOP for VGG-16's conv2_2 at batch 32); the traffic into shared
// memory is not: every (tile, channel) patch is loaded and transformed once
// per block of output channels, and U is re-read once per block of tiles, so
// the bytes moved from L2 scale with 1/TM + 1/BN.  The registers the 16
// accumulators take (16 x TM x BN f32 per block) cap the block:
//   TM = 32 output tiles x BN = 64 output channels, 16 warps, one (xi, nu)
//   GEMM per warp (2 x 4 WMMA 16x16x16 fragments, 64 f32 sums a thread),
//   one block per SM.
// With one block per SM nothing else hides the loads, so the channel loop is
// software-pipelined.  Per step of BK = 32 input channels:
//   1. the block starts copying the next step's U[:, c0:c0+BK, co0:co0+BN]
//      into the other of two shared buffers with cp.async (16-byte vectors),
//      and each thread issues the loads of the next step's 4x4 patch of one
//      tile for two neighbouring channels into registers (bf16x2: a warp
//      reads 64 contiguous bytes per patch position);
//   2. while those are in flight, each warp accumulates this step's
//      V[xi nu] @ U[xi nu] into its fragments;
//   3. once every warp is done with V, each thread does B^T d B on its
//      prefetched patch with packed bf16 adds, as the reference does its
//      butterflies in bf16 (winograd.py:31-34): every stage rounds to bf16.
//      The 16 values go to V (16 x TM x BK) in shared memory.
// After the last step the fragments go to shared memory as f32 and each
// thread applies A^T m A for a tile and a pair of output channels and writes
// the 2x2 outputs (bf16x2), masked at odd output edges.  Still to come: wgmma, and
// clusters that share one copy of U between neighbouring blocks.
//
// Entry: pl_winograd_f23(...) returns the cudaError_t of cudaGetLastError()
// after the launch.  x is NHWC bf16, u is (16, C, CO) bf16, y is NHWC
// (N, OH, OW, CO) bf16, all contiguous; C a multiple of 32, CO of 64.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TM = 32;        // output tiles per block: the M of each GEMM
constexpr int BN = 64;        // output channels per block: the N
constexpr int BK = 32;        // input channels per step: the K chunk
constexpr int THREADS = 512;  // 16 warps, one (xi, nu) each

constexpr int LDV = BK + 8;   // bf16 row pitches: multiples of 8 for WMMA
constexpr int LDU = BN + 8;
constexpr int LDM = BN + 4;   // f32 row pitch of the epilogue buffer

constexpr int U_STAGE = 16 * BK * LDU;   // elements of one U buffer; there are two
constexpr int V_BYTES = 16 * TM * LDV * 2;
constexpr int U_BYTES = 2 * U_STAGE * 2;
constexpr int M_BYTES = 16 * TM * LDM * 4;
constexpr int SMEM_BYTES = (V_BYTES + U_BYTES) > M_BYTES ? (V_BYTES + U_BYTES) : M_BYTES;

static_assert(TM * (BK / 2) == THREADS, "one (tile, channel pair) item per thread and step");
static_assert(SMEM_BYTES <= 227 * 1024, "a block's shared memory on the H100");

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

__device__ __forceinline__ void cpAsync16(void* smem, const void* gmem)
{
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(gmem));
}

// U[:, c0:c0+BK, co0:co0+BN] -> Us with cp.async, as one commit group
__device__ __forceinline__ void copyU(bf16* Us, const bf16* __restrict__ u, int C, int CO, int c0, int co0,
                                      int tid)
{
    for (int v = tid; v < 16 * BK * (BN / 8); v += THREADS) {
        const int col = (v % (BN / 8)) * 8;
        const int row = (v / (BN / 8)) % BK;
        const int k = v / ((BN / 8) * BK);
        cpAsync16(Us + (k * BK + row) * LDU + col, u + ((size_t)k * C + c0 + row) * CO + co0 + col);
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

// the 4x4 patch of this thread's tile at channels (c0 + 2 cp, c0 + 2 cp + 1);
// bit 4r + s of `inside` says whether row r, column s lies in the image
__device__ __forceinline__ void loadPatch(bf162 (&d)[4][4], const bf16* __restrict__ x, long long base,
                                          unsigned inside, int W, int C, int c0)
{
    const bf162 zero = __floats2bfloat162_rn(0.0f, 0.0f);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s)
            d[r][s] = (inside >> (4 * r + s)) & 1u
                ? *reinterpret_cast<const bf162*>(x + (base + ((long long)r * W + s) * C + c0)) : zero;
}

// B^T = ((1, 0, -1, 0), (0, 1, 1, 0), (0, -1, 1, 0), (0, 1, 0, -1)) on four values
__device__ __forceinline__ void butterfly(bf162& d0, bf162& d1, bf162& d2, bf162& d3)
{
    const bf162 t0 = __hsub2(d0, d2), t1 = __hadd2(d1, d2), t2 = __hsub2(d2, d1), t3 = __hsub2(d1, d3);
    d0 = t0; d1 = t1; d2 = t2; d3 = t3;
}

// V = B^T d B of one patch (packed bf16, rounding after each stage as the
// reference's bf16 butterflies do) -> its 16 rows of Vs
__device__ __forceinline__ void storeV(bf16* Vs, bf162 (&d)[4][4], int tl, int cp)
{
#pragma unroll
    for (int s = 0; s < 4; ++s)   // B^T along rows ...
        butterfly(d[0][s], d[1][s], d[2][s], d[3][s]);
#pragma unroll
    for (int r = 0; r < 4; ++r)   // ... then along columns
        butterfly(d[r][0], d[r][1], d[r][2], d[r][3]);

#pragma unroll
    for (int xi = 0; xi < 4; ++xi)
#pragma unroll
        for (int nu = 0; nu < 4; ++nu)
            *reinterpret_cast<bf162*>(Vs + ((xi * 4 + nu) * TM + tl) * LDV + 2 * cp) = d[xi][nu];
}

__global__ void __launch_bounds__(THREADS, 1)
winogradF23(const bf16* __restrict__ x, const bf16* __restrict__ u, bf16* __restrict__ y,
            int N, int H, int W, int C, int CO, int OH, int OW, int padH, int padW,
            int TH, int TW)
{
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* Vs = reinterpret_cast<bf16*>(smem);
    bf16* Us = reinterpret_cast<bf16*>(smem + V_BYTES);
    float* Ms = reinterpret_cast<float*>(smem);

    const int tid = threadIdx.x;
    const int xinu = tid >> 5;   // this warp's transform-domain GEMM
    const long long tiles = (long long)N * TH * TW;
    const long long t0 = (long long)blockIdx.x * TM;
    const int co0 = blockIdx.y * BN;

    // this thread's (tile, channel pair) for the input transform: the offset
    // of its patch's corner (outside the image where the conv pads) and which
    // of the 16 positions lie inside, both fixed over the channel loop
    const int tl = tid / (BK / 2), cp = tid % (BK / 2);
    const long long t = t0 + tl;
    long long base = 0;
    unsigned inside = 0;
    if (t < tiles) {
        const int n = (int)(t / (TH * TW));
        const int rem = (int)(t % (TH * TW));
        const int h0 = 2 * (rem / TW) - padH, w0 = 2 * (rem % TW) - padW;
        base = (((long long)n * H + h0) * W + w0) * C + 2 * cp;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int s = 0; s < 4; ++s)
                if (h0 + r >= 0 && h0 + r < H && w0 + s >= 0 && w0 + s < W)
                    inside |= 1u << (4 * r + s);
    }

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            wmma::fill_fragment(acc[i][j], 0.0f);

    // prologue: step 0's U in flight, its V in shared memory
    copyU(Us, u, C, CO, 0, co0, tid);
    {
        bf162 d[4][4];
        loadPatch(d, x, base, inside, W, C, 0);
        storeV(Vs, d, tl, cp);
    }

    // step i: the loads of step i + 1 (U by cp.async into the other buffer,
    // the patches into registers) are in flight while the tensor cores run
    // step i; the patches are transformed into V once every warp is done
    // reading it
    const int steps = C / BK;
    for (int i = 0; i < steps; ++i) {
        const bool more = i + 1 < steps;
        bf162 next[4][4];

        if (more) {
            copyU(Us + ((i + 1) & 1) * U_STAGE, u, C, CO, (i + 1) * BK, co0, tid);
            loadPatch(next, x, base, inside, W, C, (i + 1) * BK);
            asm volatile("cp.async.wait_group 1;\n" ::);   // step i's U has landed
        } else {
            asm volatile("cp.async.wait_group 0;\n" ::);
        }
        __syncthreads();   // ... for every thread, and so has step i's V

        const bf16* Vb = Vs + xinu * TM * LDV;
        const bf16* Ub = Us + (i & 1) * U_STAGE + xinu * BK * LDU;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
            for (int r = 0; r < 2; ++r)
                wmma::load_matrix_sync(a[r], Vb + r * 16 * LDV + kk, LDV);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
                wmma::load_matrix_sync(b, Ub + kk * LDU + j * 16, LDU);
#pragma unroll
                for (int r = 0; r < 2; ++r)
                    wmma::mma_sync(acc[r][j], a[r], b, acc[r][j]);
            }
        }
        __syncthreads();   // every warp is done with V and with this U buffer

        if (more)
            storeV(Vs, next, tl, cp);
    }

    // the loop ended on a barrier and no copy is in flight: V and U are dead,
    // their space becomes M
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            wmma::store_matrix_sync(Ms + (xinu * TM + i * 16) * LDM + j * 16, acc[i][j], LDM,
                                    wmma::mem_row_major);
    __syncthreads();

    // A^T m A for one tile and a pair of output channels; pairs fastest, so a
    // warp stores 128 contiguous bytes of a pixel's channels
    for (int item = tid; item < TM * BN / 2; item += THREADS) {
        const int col = 2 * (item % (BN / 2)), tile = item / (BN / 2);
        const long long to = t0 + tile;
        if (to >= tiles)
            continue;

        float2 m[4][4];
#pragma unroll
        for (int xi = 0; xi < 4; ++xi)
#pragma unroll
            for (int nu = 0; nu < 4; ++nu)
                m[xi][nu] = *reinterpret_cast<const float2*>(Ms + ((xi * 4 + nu) * TM + tile) * LDM + col);

        // A^T = ((1, 1, 1, 0), (0, 1, -1, -1)), along xi then nu
        float2 r0[4], r1[4];
#pragma unroll
        for (int nu = 0; nu < 4; ++nu) {
            r0[nu] = make_float2(m[0][nu].x + m[1][nu].x + m[2][nu].x, m[0][nu].y + m[1][nu].y + m[2][nu].y);
            r1[nu] = make_float2(m[1][nu].x - m[2][nu].x - m[3][nu].x, m[1][nu].y - m[2][nu].y - m[3][nu].y);
        }
        // ... then along nu: out[a][b] is output row a, column b of the tile
        const float2 out[2][2] = {
            {make_float2(r0[0].x + r0[1].x + r0[2].x, r0[0].y + r0[1].y + r0[2].y),
             make_float2(r0[1].x - r0[2].x - r0[3].x, r0[1].y - r0[2].y - r0[3].y)},
            {make_float2(r1[0].x + r1[1].x + r1[2].x, r1[0].y + r1[1].y + r1[2].y),
             make_float2(r1[1].x - r1[2].x - r1[3].x, r1[1].y - r1[2].y - r1[3].y)},
        };

        const int no = (int)(to / (TH * TW));
        const int rem = (int)(to % (TH * TW));
        const int oh0 = 2 * (rem / TW), ow0 = 2 * (rem % TW);
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b) {
                const int oh = oh0 + a, ow = ow0 + b;
                if (oh < OH && ow < OW)
                    *reinterpret_cast<bf162*>(y + (((size_t)no * OH + oh) * OW + ow) * CO + co0 + col) =
                        __float22bfloat162_rn(out[a][b]);
            }
    }
}

}  // namespace

extern "C" int pl_winograd_f23(const void* x, const void* u, void* y,
                               int n, int h, int w, int c, int co, int padH, int padW,
                               void* stream)
{
    if (c <= 0 || c % BK != 0 || co % BN != 0)
        return static_cast<int>(cudaErrorInvalidValue);

    const int oh = h + 2 * padH - 2, ow = w + 2 * padW - 2;
    const int th = (oh + 1) / 2, tw = (ow + 1) / 2;
    const long long tiles = (long long)n * th * tw;

    cudaError_t err = cudaFuncSetAttribute(winogradF23, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           SMEM_BYTES);
    if (err != cudaSuccess)
        return static_cast<int>(err);

    const dim3 grid((unsigned)((tiles + TM - 1) / TM), co / BN);
    winogradF23<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(u), static_cast<bf16*>(y),
        n, h, w, c, co, oh, ow, padH, padW, th, tw);

    return static_cast<int>(cudaGetLastError());
}
