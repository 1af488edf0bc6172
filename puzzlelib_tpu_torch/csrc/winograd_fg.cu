// Winograd F(2x2, 3x3) backward-filter in the transform domain for Hopper
// (sm_90a) on wgmma, bf16 in, f32 out.
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
// The reference itself works one xi at a time (stage-1 butterflies for one
// xi, then its four nu), so splitting the products by xi computes the same
// operands bit for bit.
//
// What bounds it on the H100 (H100 80GB HBM3 SXM, 989 TFLOP/s bf16 dense,
// 3.35 TB/s): by the data sheet, the operations (the 16 products, 2.25x fewer
// than a direct conv's) at every VGG-16 shape but conv2_2, where it is the
// bytes.  In practice the loads from L2: each xi's block reads its own x and
// dY rows, and every x patch again for each block of 128 output channels and
// every dY patch for each block of 64 input channels, about 10 KB per tile at
// conv2_2 (C = CO = 128) against 2 KB of x and dY, through 16-byte cp.async.
//
// Design:
//   - one block per (xi, 64 input channels, 128 output channels, split of
//     the tile axis), 512 threads: four warpgroups, warpgroup nu owning the
//     64 x 128 f32 sum of product (xi, nu) in registers (64 a thread).  A
//     block computes a quarter of the 16 products, so its tile can be 8192
//     sums wide (2048 when one block holds all 16);
//   - a step is a run of at most 32 tiles along one tile row (or up to 8
//     whole short rows), so the x columns that neighbouring patches share are
//     loaded once.  The block loads only what xi needs: the two x rows of
//     B^T's row xi and the dY rows of A^T's column xi, by 16-byte cp.async
//     into a two-stage ring in shared memory (zero-filled outside the
//     tensors: the conv's padding, the odd-size crop and the partial last
//     tile are all the same mask);
//   - every thread transforms one (tile, 8 channels, nu pair) of V and one
//     (tile, 8 output channels) of Mbar for all four nu, and stores them in
//     wgmma's canonical MN-major layout without swizzle (core matrices of 8
//     tiles x 16 bytes; 128 bytes between tile groups, 512 between channel
//     groups), in a two-stage operand ring;
//   - after `fence.proxy.async` and a barrier, each warpgroup issues its
//     m64n128k16 wgmma (A = V^T and B = Mbar both MN-major, the bf16
//     transpose immediates) and lets it run while the next step's loads and
//     transforms go on; `wgmma.wait_group 1` frees the ring's other stage;
//   - the tile axis is split across blocks (grid z) and each split writes its
//     own f32 partial; `sumPartials` adds the partials in split order, so the
//     gradient is deterministic (no atomics).
//
// Entry: pl_winograd_fg(...) returns the cudaError_t of cudaGetLastError()
// after the launches.  x is NHWC (N, H, W, C) bf16, dy is NHWC (N, OH, OW, CO)
// bf16 with OH = H + 2 padH - 2, du is (16, C, CO) f32, all contiguous and
// 16-byte aligned; C a multiple of 64, CO of 128.  `chunk` steps per split
// (the steps as `pl_winograd_fg_steps` cuts them); with more than one split,
// `work` holds splits x 16 x C x CO f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // input channels per block: the M of each product
constexpr int BN = 128;        // output channels per block: the N
constexpr int KT = 32;         // tiles per step at most: the K of a step
constexpr int RMAX = 8;        // whole tile rows per step at most
constexpr int THREADS = 512;   // four warpgroups, one nu each

// raw x: [row of B^T's pair (2)][8-channel chunk (8)][column slot], 16 bytes
// a unit; a step of runs x (2 len + 2) columns needs at most 2 KT + 2 RMAX
// slots, and an odd pitch keeps the cp.async writes of one pixel's chunks
// off each other's banks
constexpr int X_SLOTS = 2 * KT + 2 * RMAX;
constexpr int X_PITCH = X_SLOTS + 1;
constexpr int X_RAW_BYTES = 2 * (BM / 8) * X_PITCH * 16;

// raw dY: [a (2)][b (2)][8-channel chunk (16)][tile], 16 bytes a unit
constexpr int Y_PITCH = KT + 1;
constexpr int Y_RAW_BYTES = 4 * (BN / 8) * Y_PITCH * 16;
constexpr int RAW_BYTES = X_RAW_BYTES + Y_RAW_BYTES;

// operands of one step: V^T (64 x 32) and Mbar (32 x 128) of each nu, bf16,
// MN-major core matrices: channel group g, tile t at g * 512 + (t / 8) * 128
// + (t % 8) * 16
constexpr int LBO = 128;       // bytes between core matrices along K (tiles)
constexpr int SBO = KT * 16;   // bytes between core matrices along M / N
constexpr int V_BYTES = BM * KT * 2;
constexpr int M_BYTES = BN * KT * 2;
constexpr int OPND_BYTES = 4 * (V_BYTES + M_BYTES);

// two-stage rings of raw data and of operands (a third raw stage, with one
// operand stage, measured no faster)
constexpr int SMEM_BYTES = 2 * OPND_BYTES + 2 * RAW_BYTES;

static_assert(KT * (BM / 8) * 2 == THREADS, "one (tile, channel chunk, nu pair) of V per thread and step");
static_assert(KT * (BN / 8) == THREADS, "one (tile, output channel chunk) of Mbar per thread and step");
static_assert(RAW_BYTES % 128 == 0 && OPND_BYTES % 128 == 0, "128-byte aligned rings");
static_assert(SMEM_BYTES <= 227 * 1024, "a block's shared memory on the H100");

typedef __nv_bfloat162 bf162;

// B^T's row xi on the rows of a patch: t1 = d[first] (+ or -) d[second]
__host__ __device__ constexpr int xRow(int xi, int rr)
{
    return rr == 0 ? (xi == 0 ? 0 : xi == 2 ? 2 : 1) : (xi == 0 ? 2 : xi == 2 ? 1 : xi == 1 ? 2 : 3);
}

// A^T's column xi: its nonzero rows and their signs, A^T = ((1, 1, 1, 0),
// (0, 1, -1, -1)) (the reference's `_ACOL`)
__host__ __device__ constexpr int acolCount(int xi) { return xi == 1 || xi == 2 ? 2 : 1; }
__host__ __device__ constexpr int acolRow(int xi, int i) { return xi == 3 ? 1 : i; }
__host__ __device__ constexpr int acolSign(int xi, int i) { return xi == 3 || (xi == 2 && i == 1) ? -1 : 1; }

struct Geometry {
    int H, W, C, CO, OH, OW, padH, padW, TH, TW;
    int len, runs, segs, rows, steps, chunk;
};

// a step: `runs` tile rows from `row0`, `len` tiles each from column `j0`;
// its tile k is run k / g.len, column j0 + k % g.len
struct Step {
    int row0, runs, j0, len;
    int n0, i0;   // row0's image and tile row
};

__device__ __forceinline__ Step stepAt(const Geometry& g, int s)
{
    Step p;
    const int rg = s / g.segs, seg = s % g.segs;
    p.row0 = rg * g.runs;
    p.runs = min(g.runs, g.rows - p.row0);
    p.j0 = seg * g.len;
    p.len = min(g.len, g.TW - p.j0);
    p.n0 = p.row0 / g.TH;
    p.i0 = p.row0 - p.n0 * g.TH;
    return p;
}

// the image n and tile row i of a step's run
__device__ __forceinline__ void runRow(const Geometry& g, const Step& p, int run, int& n, int& i)
{
    n = p.n0;
    i = p.i0 + run;
    while (i >= g.TH) {
        i -= g.TH;
        ++n;
    }
}

__device__ __forceinline__ uint32_t smemAddr(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, or 16 zero bytes where `valid` is false
__device__ __forceinline__ void copy16(uint32_t dst, const void* src, bool valid)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}

// where tile k of every step lies in it: run k / len, column k % len; a
// thread works on the same few k in every step, so the divisions are made once
struct TileSlot {
    int run, q;
};

__device__ __forceinline__ TileSlot tileSlot(const Geometry& g, int k)
{
    TileSlot t;
    t.run = k / g.len;
    t.q = k - t.run * g.len;
    return t;
}

__device__ __forceinline__ bool inStep(const TileSlot& t, const Step& p)
{
    return t.run < p.runs && t.q < p.len;
}

// the x units a thread loads in every step: thread tid takes channel chunk
// tid % 8 of positions (run, row of B^T's pair, column) tid / 8, tid / 8 +
// 64, tid / 8 + 128 of a full step, packed as run << 8 | row << 7 | column
// (-1: none); a shorter step skips the positions it does not have
constexpr int X_UNITS = 3;
static_assert(X_UNITS * THREADS >= 2 * X_SLOTS * (BM / 8), "a step's x positions");

__device__ __forceinline__ void xUnits(const Geometry& g, int tid, int (&xu)[X_UNITS])
{
    const int cols = 2 * g.len + 2;
#pragma unroll
    for (int m = 0; m < X_UNITS; ++m) {
        const int pos = (tid >> 3) + m * (THREADS / 8);
        const int rowPair = pos / cols, col = pos - rowPair * cols;
        xu[m] = (rowPair >> 1) < g.runs ? (rowPair >> 1) << 8 | (rowPair & 1) << 7 | col : -1;
    }
}

// one step's raw x rows and dY rows into a raw stage.  dY: thread tid loads
// output channel chunk tid % 16, column b = tid / 16 % 2 of its two tiles of
// the step, each row of A^T's column xi
template <int XI>
__device__ __forceinline__ void loadStep(unsigned char* raw, const __nv_bfloat16* __restrict__ x,
                                         const __nv_bfloat16* __restrict__ dy, const Geometry& g, const Step& p,
                                         int c0, int co0, int tid, const int (&xu)[X_UNITS],
                                         const TileSlot (&ky)[2])
{
    const uint32_t xr = smemAddr(raw), yr = smemAddr(raw + X_RAW_BYTES);

    const int ch = tid & 7;
#pragma unroll
    for (int m = 0; m < X_UNITS; ++m) {
        const int run = xu[m] >> 8, rr = (xu[m] >> 7) & 1, col = xu[m] & 127;
        if (xu[m] < 0 || run >= p.runs || col >= 2 * p.len + 2)
            continue;

        int n, i;
        runRow(g, p, run, n, i);
        const int h = 2 * i - g.padH + (rr == 0 ? xRow(XI, 0) : xRow(XI, 1));
        const int w = 2 * p.j0 - g.padW + col;
        const bool valid = h >= 0 && h < g.H && w >= 0 && w < g.W;

        const __nv_bfloat16* src = valid ? x + ((((long long)n * g.H + h) * g.W + w) * g.C + c0 + ch * 8) : x;
        copy16(xr + ((rr * (BM / 8) + ch) * X_PITCH + run * (2 * g.len + 2) + col) * 16, src, valid);
    }

    const int cc = tid & 15, b = (tid >> 4) & 1;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int k = (tid >> 5) + 16 * half;
        if (!inStep(ky[half], p))
            continue;

        int n, i;
        runRow(g, p, ky[half].run, n, i);
        const int ow = 2 * (p.j0 + ky[half].q) + b;
#pragma unroll
        for (int ai = 0; ai < acolCount(XI); ++ai) {
            const int a = acolRow(XI, ai);
            const int oh = 2 * i + a;
            const bool valid = oh < g.OH && ow < g.OW;

            const __nv_bfloat16* src =
                valid ? dy + ((((long long)n * g.OH + oh) * g.OW + ow) * g.CO + co0 + cc * 8) : dy;
            copy16(yr + (((a * 2 + b) * (BN / 8) + cc) * Y_PITCH + k) * 16, src, valid);
        }
    }
}

// packed bf16 arithmetic on 8 values, rounded per operation
__device__ __forceinline__ uint4 add8(uint4 a, uint4 b)
{
    uint4 r;
    bf162* o = reinterpret_cast<bf162*>(&r);
    const bf162* p = reinterpret_cast<const bf162*>(&a);
    const bf162* q = reinterpret_cast<const bf162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i)
        o[i] = __hadd2(p[i], q[i]);
    return r;
}

__device__ __forceinline__ uint4 sub8(uint4 a, uint4 b)
{
    uint4 r;
    bf162* o = reinterpret_cast<bf162*>(&r);
    const bf162* p = reinterpret_cast<const bf162*>(&a);
    const bf162* q = reinterpret_cast<const bf162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i)
        o[i] = __hsub2(p[i], q[i]);
    return r;
}

__device__ __forceinline__ uint4 neg8(uint4 a)
{
    uint4 r;
    bf162* o = reinterpret_cast<bf162*>(&r);
    const bf162* p = reinterpret_cast<const bf162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i)
        o[i] = __hneg2(p[i]);
    return r;
}

// Mbar[xi nu] of 8 output channels: the signed dY terms of A^T's columns xi
// (rows a, outer) and nu (columns b, inner), summed left to right in bf16
template <int XI, int NU>
__device__ __forceinline__ uint4 mbar(const uint4 (&d)[2][2])
{
    uint4 m = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < acolCount(XI); ++i)
#pragma unroll
        for (int j = 0; j < acolCount(NU); ++j) {
            const uint4 term = d[acolRow(XI, i)][acolRow(NU, j)];
            const bool plus = acolSign(XI, i) * acolSign(NU, j) > 0;
            if (i == 0 && j == 0)
                m = plus ? term : neg8(term);
            else
                m = plus ? add8(m, term) : sub8(m, term);
        }
    return m;
}

__device__ __forceinline__ int opndOffset(int group, int k)
{
    return group * SBO + (k >> 3) * LBO + (k & 7) * 16;
}

// one step's V (this thread's tile, channel chunk and nu pair) and Mbar (its
// tile and output channel chunk, all four nu) from a raw stage into an
// operand stage; tiles past the step's end get zeros
template <int XI>
__device__ __forceinline__ void transformStep(unsigned char* opnd, const unsigned char* raw, const Geometry& g,
                                              const Step& p, int tid, const TileSlot& kt)
{
    const int k = tid & 31;
    const int run = kt.run, q = kt.q;
    const bool valid = inStep(kt, p);
    const uint4 zero = make_uint4(0, 0, 0, 0);

    {
        const int pair = (tid >> 5) & 1, ch = tid >> 6;
        uint4 v0 = zero, v1 = zero;
        if (valid) {
            const uint4* xr = reinterpret_cast<const uint4*>(raw);
            const int slot = run * (2 * g.len + 2) + 2 * q;

            // t1 of columns pair .. pair + 2, each B^T row stage rounded
            uint4 t1[3];
#pragma unroll
            for (int b = 0; b < 3; ++b) {
                const uint4 first = xr[ch * X_PITCH + slot + pair + b];
                const uint4 second = xr[((BM / 8) + ch) * X_PITCH + slot + pair + b];
                t1[b] = XI == 1 ? add8(first, second) : sub8(first, second);
            }

            // nu = 0, 1 from columns 0..2; nu = 2, 3 from columns 1..3
            if (pair == 0) {
                v0 = sub8(t1[0], t1[2]);
                v1 = add8(t1[1], t1[2]);
            } else {
                v0 = sub8(t1[1], t1[0]);
                v1 = sub8(t1[0], t1[2]);
            }
        }

        *reinterpret_cast<uint4*>(opnd + (2 * pair) * V_BYTES + opndOffset(ch, k)) = v0;
        *reinterpret_cast<uint4*>(opnd + (2 * pair + 1) * V_BYTES + opndOffset(ch, k)) = v1;
    }

    {
        const int cc = tid >> 5;
        uint4 m[4] = {zero, zero, zero, zero};
        if (valid) {
            const uint4* yr = reinterpret_cast<const uint4*>(raw + X_RAW_BYTES);
            uint4 d[2][2] = {{zero, zero}, {zero, zero}};
#pragma unroll
            for (int i = 0; i < acolCount(XI); ++i)
#pragma unroll
                for (int b = 0; b < 2; ++b) {
                    const int a = acolRow(XI, i);
                    d[a][b] = yr[((a * 2 + b) * (BN / 8) + cc) * Y_PITCH + k];
                }

            m[0] = mbar<XI, 0>(d);
            m[1] = mbar<XI, 1>(d);
            m[2] = mbar<XI, 2>(d);
            m[3] = mbar<XI, 3>(d);
        }

        unsigned char* ms = opnd + 4 * V_BYTES;
#pragma unroll
        for (int nu = 0; nu < 4; ++nu)
            *reinterpret_cast<uint4*>(ms + nu * M_BYTES + opndOffset(cc, k)) = m[nu];
    }
}

// a shared-memory matrix descriptor without swizzle
__device__ __forceinline__ uint64_t descriptor(const void* p)
{
    return (uint64_t)((smemAddr(p) & 0x3FFFF) >> 4) | ((uint64_t)(LBO >> 4) << 16) | ((uint64_t)(SBO >> 4) << 32);
}

// acc = A B + (accumulate ? acc : 0), m64n128k16, A = V^T and B = Mbar both
// MN-major (transposed).  The first product of a block starts the sum with
// accumulate = 0: no instruction outside wgmma defines the sum's registers,
// so the compiler leaves the products asynchronous
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da, uint64_t db, int accumulate)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
        "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, %64, %65, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
}

template <int XI>
__device__ __forceinline__ void filterGradBlock(const __nv_bfloat16* __restrict__ x,
                                                const __nv_bfloat16* __restrict__ dy, float* __restrict__ out,
                                                const Geometry& g, unsigned char* smem)
{
    unsigned char* const opnd = smem;
    unsigned char* const raw = smem + 2 * OPND_BYTES;

    const int tid = threadIdx.x, nu = tid >> 7;
    const TileSlot kt = tileSlot(g, tid & 31);
    const TileSlot ky[2] = {tileSlot(g, tid >> 5), tileSlot(g, (tid >> 5) + 16)};
    int xu[X_UNITS];
    xUnits(g, tid, xu);

    const int coTiles = g.CO / BN;
    const int co0 = (blockIdx.x % coTiles) * BN, c0 = (blockIdx.x / coTiles) * BM;

    const int s0 = blockIdx.z * g.chunk;
    const int steps = min(g.chunk, g.steps - s0);

    float acc[64];   // set by the first product

    loadStep<XI>(raw, x, dy, g, stepAt(g, s0), c0, co0, tid, xu, ky);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    for (int i = 0; i < steps; ++i) {
        // step i + 1's loads fly while step i is transformed and multiplied;
        // their raw stage was last read by step i - 1's transforms
        if (i + 1 < steps)
            loadStep<XI>(raw + ((i + 1) & 1) * RAW_BYTES, x, dy, g, stepAt(g, s0 + i + 1), c0, co0, tid, xu, ky);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        // step i - 2's products are done: its operand stage is free
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        __syncthreads();   // step i's raw data is in, and every warpgroup is past that wait

        const Step p = stepAt(g, s0 + i);
        unsigned char* const o = opnd + (i & 1) * OPND_BYTES;
        transformStep<XI>(o, raw + (i & 1) * RAW_BYTES, g, p, tid, kt);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();   // step i's operands are in, visible to the tensor cores

        const unsigned char* vs = o + nu * V_BYTES;
        const unsigned char* ms = o + 4 * V_BYTES + nu * M_BYTES;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        wgmma(acc, descriptor(vs), descriptor(ms), i > 0);
        wgmma(acc, descriptor(vs + 2 * LBO), descriptor(ms + 2 * LBO), 1);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

    // this split's dU[xi nu][c0:c0+64][co0:co0+128]: thread (warp w, lane l)
    // holds rows 16 w + l / 4 (+ 8) and columns 8 j + 2 (l % 4) (+ 1)
    const int w = (tid >> 5) & 3, l = tid & 31;
    float* o = out + ((size_t)blockIdx.z * 16 + XI * 4 + nu) * g.C * g.CO;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = c0 + 16 * w + l / 4 + 8 * h, col = co0 + 8 * j + 2 * (l % 4);
            *reinterpret_cast<float2*>(o + (size_t)row * g.CO + col) = make_float2(acc[4 * j + 2 * h],
                                                                                   acc[4 * j + 2 * h + 1]);
        }
}

__global__ void __launch_bounds__(THREADS, 1)
winogradFG(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy, float* __restrict__ out,
           const Geometry g)
{
    extern __shared__ __align__(128) unsigned char smem[];

    switch (blockIdx.y) {
    case 0: filterGradBlock<0>(x, dy, out, g, smem); break;
    case 1: filterGradBlock<1>(x, dy, out, g, smem); break;
    case 2: filterGradBlock<2>(x, dy, out, g, smem); break;
    default: filterGradBlock<3>(x, dy, out, g, smem); break;
    }
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

// How the tile axis is cut into steps (`filterGrad`'s `_stepGeometry` in
// ops/hopper/winograd.py is the same rule): a tile row of tw > KT tiles in
// `segs` runs of `len` tiles (the last may be shorter), or up to RMAX whole
// rows of tw <= KT tiles together; `steps` over the n * th tile rows.
extern "C" void pl_winograd_fg_steps(int n, int th, int tw, int* len, int* runs, int* segs, int* steps)
{
    *segs = (tw + KT - 1) / KT;
    *len = (tw + *segs - 1) / *segs;
    *runs = *segs > 1 ? 1 : (KT / tw < RMAX ? KT / tw : RMAX);
    *steps = (n * th + *runs - 1) / *runs * *segs;
}

extern "C" int pl_winograd_fg(const void* x, const void* dy, void* du, void* work,
                              int n, int h, int w, int c, int co, int padH, int padW, int chunk,
                              void* stream)
{
    const int oh = h + 2 * padH - 2, ow = w + 2 * padW - 2;
    if (n <= 0 || c <= 0 || c % BM != 0 || co <= 0 || co % BN != 0 || oh <= 0 || ow <= 0 || padH < 0 || padW < 0)
        return static_cast<int>(cudaErrorInvalidValue);

    Geometry g;
    g.H = h; g.W = w; g.C = c; g.CO = co; g.OH = oh; g.OW = ow; g.padH = padH; g.padW = padW;
    g.TH = (oh + 1) / 2;
    g.TW = (ow + 1) / 2;
    g.rows = n * g.TH;
    pl_winograd_fg_steps(n, g.TH, g.TW, &g.len, &g.runs, &g.segs, &g.steps);
    g.chunk = chunk;

    if (chunk <= 0)
        return static_cast<int>(cudaErrorInvalidValue);

    const int splits = (g.steps + chunk - 1) / chunk;
    if (splits > 65535 || (splits > 1 && work == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);

    cudaError_t err = cudaFuncSetAttribute(winogradFG, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess)
        return static_cast<int>(err);

    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* partials = splits > 1 ? static_cast<float*>(work) : static_cast<float*>(du);

    const dim3 grid((c / BM) * (co / BN), 4, (unsigned)splits);
    winogradFG<<<grid, THREADS, SMEM_BYTES, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                 static_cast<const __nv_bfloat16*>(dy), partials, g);

    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1)
        return static_cast<int>(err);

    const long long n4 = 4LL * c * co;   // 16 * c * co / 4 float4s
    const long long blocks = (n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096;
    sumPartials<<<(unsigned)blocks, 256, 0, s>>>(static_cast<const float4*>(work), static_cast<float4*>(du),
                                                 splits, n4);

    return static_cast<int>(cudaGetLastError());
}
