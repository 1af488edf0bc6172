// Fused Winograd F(2x2, 3x3) forward convolution for Hopper (sm_90a) on
// wgmma, bf16 in and out, f32 sums.
//
// Replaces the Pallas TPU kernel puzzlelib_tpu/ops/pallas/winograd.py `_kernel`
// (wrappers `_winogradHC`, `conv2dNHWC`, `conv2d`).  Each 4x4 input patch
// (stride 2) gives one 2x2 output tile through
//
//     Y = A^T [ U . (B^T d B) ] A,      U = G g G^T (computed by the caller),
//
// the elementwise product over channels being 16 GEMMs of depth C, one per
// transform-domain position (xi, nu).  As on the TPU, the whole pipeline is
// one kernel: the 16x transform-domain tensor never goes to device memory.
//
// Rounding points, those of the reference kernel: each butterfly stage of
// V = B^T d B is rounded to bf16 (packed bf16 adds), U is bf16, every sum is
// in f32 and y is rounded to bf16 once.  Only the order of the f32 sums is
// this kernel's own:
//
//     R_b(xi) = sum over nu in N_b of s_b(nu) V[xi nu] U[xi nu]  (over c),
//     N_0 = {0, 1, 2}, signs (+, +, +);   N_1 = {1, 2, 3}, signs (+, -, -),
//     Y[0, b] = R_b(0) + R_b(1) + R_b(2),   Y[1, b] = R_b(1) - R_b(2) - R_b(3),
//
// Y[a, b] being output pixel (2i + a, 2j + b) of tile (i, j) and A^T =
// ((1, 1, 1, 0), (0, 1, -1, -1)).  The tensor cores do both signed sums:
// every product of N_b goes straight into Y[a, b] for each a with A^T[a][xi]
// != 0, its sign A^T[a][xi] s_b(nu) as wgmma's imm-scale-b.  The input
// channels are the outer loop, in steps of 32, and xi the inner one, in the
// order 0, 3, 1, 2 (the first step starts Y[0, b], the second Y[1, b]); no
// register arithmetic touches a sum before the epilogue.  That is 36
// products per (tile, c, co) against the algorithm's 16, for a kernel bound
// by its loads: xi = 1 and 2 each go into both rows of Y.  Summing R_b apart
// and folding it into Y once per xi pass would take 24, but its third sum of
// 64 registers a thread made ptxas spill (255 registers, 512 bytes of spill
// stores): that variant did not land.
//
// What bounds it on the H100 (H100 80GB HBM3 SXM, 989 TFLOP/s bf16 dense,
// 3.35 TB/s): by the data sheet the operations at every VGG-16 shape but
// conv2_2, where it is the bytes.  Measured, as for K3
// (csrc/winograd_fg.cu), the delivery from L2: U is read again for every
// block of tiles (C * CO * 16 * 2 / 64 bytes a tile) and each x row for
// every block of output channels.  The block is as large as the registers
// allow, 64 tiles x 128 output channels (PR 1's WMMA design: 32 x 64), which
// halves both terms.  Loads through L1 (`cp.async.ca`) measured faster than
// past it (`.cg`), with either order of the loops.
//
// Design:
//   - one block per (run of at most 64 tiles along one tile row, or up to 8
//     whole short rows; 128 output channels): K3's step rule with 64 and 8.
//     Every VGG-16 shape fills 56 of the 64 rows of M.  256 threads in two
//     warpgroups; warpgroup b owns output column b of the block's tiles:
//     Y[0, b] and Y[1, b] as m64n128 f32 sums, 128 f32 a thread;
//   - a step is (32 input channels, xi).  The block loads by 16-byte
//     cp.async only the two x rows that B^T's row xi reads (zero-filled
//     outside the image: the conv's padding, the odd-size crop and the
//     partial last tile are one mask), and U[xi nu] of the step's channels
//     for the four nu straight into its operand layout (B, MN-major as K3's
//     Mbar).  Loading the four rows once for the four xi of a channel step
//     instead measured slower: the registers it took made ptxas spill;
//   - every thread transforms one (tile, 8 channels) of V for the four nu in
//     packed bf16 and stores it K-major (A: core matrices of 8 tiles x 16
//     bytes, 128 bytes between tile groups, 1024 between channel groups);
//   - after fence.proxy.async and a barrier each warpgroup issues its
//     m64n128k16 wgmma (three nu, two k-slices, into one or both rows of Y),
//     the first of each sum with scale-d 0, and lets them run while the next
//     step is transformed; the loads of step j + AHEAD fly meanwhile, and
//     `wgmma.wait_group 1` frees a step's U and V slots two steps later.  U,
//     V and raw x have rings of their own (AHEAD + 2, 2 and AHEAD + 1
//     slots; loading 2 steps ahead measured no faster than 1).  The
//     warpgroup's index is broadcast from lane 0 (`__shfl_sync`), so that
//     ptxas sees the branch between the two warpgroups' sign patterns as
//     uniform and keeps the products asynchronous;
//   - the epilogue rounds Y to bf16 in registers and writes NHWC, masked at
//     the odd edges.
//
// Entry: pl_winograd_f23(...) returns the cudaError_t of cudaGetLastError()
// after the launch.  x is NHWC (N, H, W, C) bf16, u is (16, C, CO) bf16, y is
// NHWC (N, OH, OW, CO) bf16 with OH = H + 2 padH - 2, all contiguous and
// 16-byte aligned; C a multiple of 32, CO of 128.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;         // tiles per block at most: the M of each product
constexpr int BN = 128;        // output channels per block: the N
constexpr int BK = 32;         // input channels per step: the K of a step
constexpr int RMAX = 8;        // whole tile rows per block at most
constexpr int THREADS = 256;   // two warpgroups, one output column each
constexpr int AHEAD = 1;       // steps whose loads fly while a step is transformed and multiplied

// operands, bf16 without swizzle, in core matrices of 8 rows x 16 bytes.
// A = V[xi nu] (TM tiles x BK channels), K-major: tile k, channels 8 g ..
// 8 g + 7 at g * A_LBO + (k / 8) * A_SBO + (k % 8) * 16
constexpr int A_LBO = TM * 16;   // bytes between core matrices along K (channels)
constexpr int A_SBO = 128;       // along M (tiles)
constexpr int V_BYTES = TM * BK * 2;

// B = U[xi nu] (BK channels x BN output channels), MN-major: channel c,
// output channels 8 g .. 8 g + 7 at g * B_SBO + (c / 8) * B_LBO + (c % 8) * 16
constexpr int B_LBO = 128;       // along K (channels)
constexpr int B_SBO = BK * 16;   // along N (output channels)
constexpr int U_BYTES = BK * BN * 2;

// raw x: [row of B^T's pair (2)][8-channel chunk (4)][column slot], 16 bytes
// a unit; a block's runs x (2 len + 2) columns need at most 2 TM + 2 RMAX
// slots
constexpr int X_SLOTS = 2 * TM + 2 * RMAX;
constexpr int X_PITCH = X_SLOTS + 1;
constexpr int X_RAW_BYTES = 2 * (BK / 8) * X_PITCH * 16;

// the rings of a step's U (four nu), V (four nu) and raw x.  Step j loads
// into U slot j % U_RING and raw slot j % X_RING, and transforms into V slot
// j % V_RING; the loads of step j + AHEAD are issued at step j, into the
// slots that the products of step j - 2 and the transform of step j - 1 have
// left
constexpr int U_RING = AHEAD + 2, X_RING = AHEAD + 1, V_RING = 2;
constexpr int U_STAGE = 4 * U_BYTES, V_STAGE = 4 * V_BYTES;
constexpr int V_BASE = U_RING * U_STAGE;
constexpr int X_BASE = V_BASE + V_RING * V_STAGE;
constexpr int SMEM_BYTES = X_BASE + X_RING * X_RAW_BYTES;

static_assert(TM * (BK / 8) == THREADS, "one (tile, channel chunk) of V per thread and step");
static_assert(4 * BK * (BN / 8) == 8 * THREADS, "eight 16-byte units of U per thread and step");
static_assert(V_BASE % 128 == 0 && X_BASE % 128 == 0 && X_RAW_BYTES % 128 == 0, "128-byte aligned slots");
static_assert(AHEAD >= 0 && SMEM_BYTES <= 227 * 1024, "a block's shared memory on the H100");

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

// B^T's row xi on the rows of a patch: t1 = d[first] (+ or -) d[second]
__host__ __device__ constexpr int xRow(int xi, int rr)
{
    return rr == 0 ? (xi == 0 ? 0 : xi == 2 ? 2 : 1) : (xi == 0 ? 2 : xi == 2 ? 1 : xi == 1 ? 2 : 3);
}

// A^T's signs: output column b sums nu = b + j, j = 0, 1, 2, with sign
// nuSign(b, j) (N_b above); output row a takes xi with sign atEntry(a, xi) =
// A^T[a][xi]; the passes over xi run in the order passXi(0..3)
__host__ __device__ constexpr int nuSign(int b, int j) { return b == 0 || j == 0 ? 1 : -1; }
__host__ __device__ constexpr int atEntry(int a, int xi) { return a == 0 ? (xi < 3 ? 1 : 0) : (xi == 0 ? 0 : xi == 1 ? 1 : -1); }
__host__ __device__ constexpr int passXi(int pass) { return pass == 0 ? 0 : pass == 1 ? 3 : pass - 1; }

// step j's slots of the rings
struct Slots {
    unsigned char *u, *v, *x;
};

__device__ __forceinline__ Slots slotsOf(unsigned char* smem, int j)
{
    return {smem + (j % U_RING) * U_STAGE, smem + V_BASE + (j % V_RING) * V_STAGE,
            smem + X_BASE + (j % X_RING) * X_RAW_BYTES};
}

struct Geometry {
    int H, W, C, CO, OH, OW, padH, padW, TH, TW;
    int len, runs, segs, rows, blocks;
};

// a block's tiles: `runs` tile rows from `row0`, `len` tiles each from
// column `j0`; its tile k is run k / g.len, column j0 + k % g.len
struct Tiles {
    int row0, runs, j0, len;
    int n0, i0;   // row0's image and tile row
};

__device__ __forceinline__ Tiles tilesAt(const Geometry& g, int s)
{
    Tiles p;
    const int rg = s / g.segs, seg = s % g.segs;
    p.row0 = rg * g.runs;
    p.runs = min(g.runs, g.rows - p.row0);
    p.j0 = seg * g.len;
    p.len = min(g.len, g.TW - p.j0);
    p.n0 = p.row0 / g.TH;
    p.i0 = p.row0 - p.n0 * g.TH;
    return p;
}

// the image n and tile row i of a block's run
__device__ __forceinline__ void runRow(const Geometry& g, const Tiles& p, int run, int& n, int& i)
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
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}

// where tile k of the block lies: run k / len, column k % len
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

__device__ __forceinline__ bool inTiles(const TileSlot& t, const Tiles& p)
{
    return t.run < p.runs && t.q < p.len;
}

// the x units a thread loads in every step: channel chunk tid % 4 of
// positions (run, row of B^T's pair, column) tid / 4 + 64 m, packed as
// run << 9 | row << 8 | column (-1: none)
constexpr int X_UNITS = 5;
static_assert(X_UNITS * (THREADS / 4) >= 2 * X_SLOTS, "a step's x positions");

__device__ __forceinline__ void xUnits(const Geometry& g, const Tiles& p, int tid, int (&xu)[X_UNITS])
{
    const int cols = 2 * g.len + 2;
#pragma unroll
    for (int m = 0; m < X_UNITS; ++m) {
        const int pos = (tid >> 2) + m * (THREADS / 4);
        const int rowPair = pos / cols, col = pos - rowPair * cols, run = rowPair >> 1;
        xu[m] = run < p.runs && col < 2 * p.len + 2 ? run << 9 | (rowPair & 1) << 8 | col : -1;
    }
}

// one step's U and raw x rows into its slots: U[xi nu][c0 + r][co0 + 8 g ..]
// with lanes on 16 rows x 2 neighbouring chunks (a 32-byte sector of a row
// each), so that a warp's writes fill four 128-byte lines; x as `xUnits` says
__device__ __forceinline__ void loadStep(const Slots& sl, const bf16* __restrict__ x, const bf16* __restrict__ u,
                                         const Geometry& g, const Tiles& p, int xi, int c0, int co0, int tid,
                                         const int (&xu)[X_UNITS])
{
    const uint32_t us = smemAddr(sl.u), xs = smemAddr(sl.x);

#pragma unroll
    for (int m = 0; m < 8; ++m) {
        const int v = m * THREADS + tid;
        const int grp = ((v >> 6) & 7) << 1 | (v & 1), r = (v >> 1) & 31, nu = v >> 9;
        copy16(us + nu * U_BYTES + grp * B_SBO + (r >> 3) * B_LBO + (r & 7) * 16,
               u + ((size_t)(xi * 4 + nu) * g.C + c0 + r) * g.CO + co0 + grp * 8, true);
    }

    const int ch = tid & 3;
#pragma unroll
    for (int m = 0; m < X_UNITS; ++m) {
        if (xu[m] < 0)
            continue;

        const int run = xu[m] >> 9, rr = (xu[m] >> 8) & 1, col = xu[m] & 255;
        int n, i;
        runRow(g, p, run, n, i);
        const int h = 2 * i - g.padH + xRow(xi, rr);
        const int w = 2 * p.j0 - g.padW + col;
        const bool valid = h >= 0 && h < g.H && w >= 0 && w < g.W;

        const bf16* src = valid ? x + ((((long long)n * g.H + h) * g.W + w) * g.C + c0 + ch * 8) : x;
        copy16(xs + ((rr * (BK / 8) + ch) * X_PITCH + run * (2 * g.len + 2) + col) * 16, src, valid);
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

// V[xi nu] of this thread's tile and 8 channels for the four nu, from a
// step's raw x into its V; tiles past the block's end get zeros
template <int XI>
__device__ __forceinline__ void transformStep(const Slots& sl, const Geometry& g, const Tiles& p, int tid,
                                              const TileSlot& kt)
{
    const int k = tid & (TM - 1), ch = tid / TM;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    uint4 v[4] = {zero, zero, zero, zero};

    if (inTiles(kt, p)) {
        const uint4* xr = reinterpret_cast<const uint4*>(sl.x);
        const int slot = kt.run * (2 * g.len + 2) + 2 * kt.q;

        // t1 of the patch's four columns: B^T's row xi, rounded
        uint4 t1[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            const uint4 first = xr[ch * X_PITCH + slot + b];
            const uint4 second = xr[((BK / 8) + ch) * X_PITCH + slot + b];
            t1[b] = XI == 1 ? add8(first, second) : sub8(first, second);
        }

        // ... then B^T along the columns
        v[0] = sub8(t1[0], t1[2]);
        v[1] = add8(t1[1], t1[2]);
        v[2] = sub8(t1[2], t1[1]);
        v[3] = sub8(t1[1], t1[3]);
    }

    unsigned char* vs = sl.v + ch * A_LBO + (k >> 3) * A_SBO + (k & 7) * 16;
#pragma unroll
    for (int nu = 0; nu < 4; ++nu)
        *reinterpret_cast<uint4*>(vs + nu * V_BYTES) = v[nu];
}

// a shared-memory matrix descriptor without swizzle
__device__ __forceinline__ uint64_t descriptor(const void* p, int lbo, int sbo)
{
    return (uint64_t)((smemAddr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// acc = SIGN A B + (accumulate ? acc : 0), m64n128k16, A = V K-major and B =
// U MN-major (transposed).  The first product of a sum starts it with
// accumulate = 0: no instruction outside wgmma defines the sum's registers,
// so the compiler leaves the products asynchronous
template <int SIGN>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da, uint64_t db, int accumulate)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
        "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, %64, %65, p, 1, %67, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate), "n"(SIGN));
}

// acc (+)= SIGN V[xi nu] U[xi nu] over a step's 32 channels: two k-slices
template <int SIGN>
__device__ __forceinline__ void product(float (&acc)[64], const Slots& sl, int nu, int accumulate)
{
    const unsigned char* vs = sl.v + nu * V_BYTES;
    const unsigned char* us = sl.u + nu * U_BYTES;
    wgmma<SIGN>(acc, descriptor(vs, A_LBO, A_SBO), descriptor(us, B_LBO, B_SBO), accumulate);
    wgmma<SIGN>(acc, descriptor(vs + 2 * A_LBO, A_LBO, A_SBO), descriptor(us + 2 * B_LBO, B_LBO, B_SBO), 1);
}

// warpgroup B's products of a step into one sum: N_B with their signs,
// times SIGMA
template <int B, int SIGMA>
__device__ __forceinline__ void products(float (&acc)[64], const Slots& sl, int accumulate)
{
    product<SIGMA * nuSign(B, 0)>(acc, sl, B, accumulate);
    product<SIGMA * nuSign(B, 1)>(acc, sl, B + 1, 1);
    product<SIGMA * nuSign(B, 2)>(acc, sl, B + 2, 1);
}

// ties the registers of a sum to this point of the program, so that the
// compiler neither reads them before a wait for the products nor moves
// their other uses across one
__device__ __forceinline__ void fenceSum(float (&acc)[64])
{
#pragma unroll
    for (int i = 0; i < 64; ++i)
        asm volatile("" : "+f"(acc[i])::"memory");
}

struct Block {
    const bf16* x;
    const bf16* u;
    const Geometry& g;
    unsigned char* smem;
    Tiles p;
    TileSlot kt;
    int co0, tid, b, cs;
    int xu[X_UNITS];

    __device__ __forceinline__ void load(int j)
    {
        loadStep(slotsOf(smem, j), x, u, g, p, passXi(j % 4), (j / 4) * BK, co0, tid, xu);
    }

    // step j (of 4 cs) up to its products: the loads of step j + AHEAD, the
    // wait for step j's loads, its transform; returns step j's slots
    template <int XI>
    __device__ __forceinline__ Slots prepare(int j)
    {
        // every thread is past step j - 1's transform and every warpgroup
        // past its wait for step j - 2's products
        __syncthreads();
        if (j + AHEAD < 4 * cs)
            load(j + AHEAD);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        asm volatile("cp.async.wait_group %0;\n" ::"n"(AHEAD) : "memory");
        __syncthreads();   // step j's loads are in, for every thread

        const Slots sl = slotsOf(smem, j);
        transformStep<XI>(sl, g, p, tid, kt);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();   // step j's operands are in, visible to the tensor cores
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        return sl;
    }

    // step j (xi = XI): N_b's products into Y[a, b] for each a with
    // A^T[a][XI] != 0; Y[0, b] starts at step 0 (xi = 0), Y[1, b] at step 1
    // (xi = 3)
    template <int XI>
    __device__ __forceinline__ void step(float (&y0)[64], float (&y1)[64], int j)
    {
        const Slots sl = prepare<XI>(j);
        if (b == 0)
            issue<0, XI>(y0, y1, sl, j);
        else
            issue<1, XI>(y0, y1, sl, j);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    }

    template <int B, int XI>
    __device__ __forceinline__ void issue(float (&y0)[64], float (&y1)[64], const Slots& sl, int j)
    {
        if constexpr (atEntry(0, XI) != 0)
            products<B, atEntry(0, XI)>(y0, sl, j > 0);
        if constexpr (atEntry(1, XI) != 0)
            products<B, atEntry(1, XI)>(y1, sl, j > 1);
    }
};

// one output row of a thread's tile h (of two) to bf16: columns 8 j + 2 (l % 4)
// (+ 1) of the warpgroup's m64n128 sum
__device__ __forceinline__ void storeRow(bf16* out, const float (&acc)[64], int h)
{
#pragma unroll
    for (int j = 0; j < 16; ++j)
        *reinterpret_cast<bf162*>(out + 8 * j) = __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

__global__ void __launch_bounds__(THREADS, 1)
winogradF23(const bf16* __restrict__ x, const bf16* __restrict__ u, bf16* __restrict__ y, const Geometry g)
{
    extern __shared__ __align__(128) unsigned char smem[];

    const int tid = threadIdx.x, coTiles = g.CO / BN;
    Block blk{x, u, g, smem, tilesAt(g, blockIdx.x / coTiles), tileSlot(g, tid & (TM - 1)),
              (int)(blockIdx.x % coTiles) * BN, tid, __shfl_sync(0xFFFFFFFFu, tid >> 7, 0), g.C / BK, {}};
    xUnits(g, blk.p, tid, blk.xu);

    for (int j = 0; j < AHEAD; ++j) {
        blk.load(j);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }

    float y0[64], y1[64];   // each set by its first product
    static_assert(passXi(0) == 0 && passXi(1) == 3 && passXi(2) == 1 && passXi(3) == 2, "the order of the passes");
    for (int s = 0; s < blk.cs; ++s) {
        blk.step<passXi(0)>(y0, y1, 4 * s);
        blk.step<passXi(1)>(y0, y1, 4 * s + 1);
        blk.step<passXi(2)>(y0, y1, 4 * s + 2);
        blk.step<passXi(3)>(y0, y1, 4 * s + 3);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fenceSum(y0);
    fenceSum(y1);

    // thread (warp w of its warpgroup, lane l) holds tiles 16 w + l / 4 and
    // 16 w + l / 4 + 8, output channels 8 j + 2 (l % 4) (+ 1)
    const int w = (tid >> 5) & 3, l = tid & 31;
    const Tiles& p = blk.p;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const TileSlot t = tileSlot(g, 16 * w + l / 4 + 8 * h);
        const int ow = 2 * (p.j0 + t.q) + blk.b;
        if (!inTiles(t, p) || ow >= g.OW)
            continue;

        int n, i;
        runRow(g, p, t.run, n, i);
        bf16* out = y + (((size_t)n * g.OH + 2 * i) * g.OW + ow) * g.CO + blk.co0 + 2 * (l & 3);
        storeRow(out, y0, h);
        if (2 * i + 1 < g.OH)
            storeRow(out + (size_t)g.OW * g.CO, y1, h);
    }
}

}  // namespace

// How the tiles are cut into blocks (K3's step rule, `pl_winograd_fg_steps`
// in csrc/winograd_fg.cu, with TM and RMAX): a tile row of tw > TM tiles in
// `segs` runs of `len` tiles (the last may be shorter), or up to RMAX whole
// rows of tw <= TM tiles together; one block per (run group, 128 output
// channels).
extern "C" int pl_winograd_f23(const void* x, const void* u, void* y,
                               int n, int h, int w, int c, int co, int padH, int padW,
                               void* stream)
{
    const int oh = h + 2 * padH - 2, ow = w + 2 * padW - 2;
    if (n <= 0 || c <= 0 || c % BK != 0 || co <= 0 || co % BN != 0 || oh <= 0 || ow <= 0 || padH < 0 || padW < 0)
        return static_cast<int>(cudaErrorInvalidValue);

    Geometry g;
    g.H = h; g.W = w; g.C = c; g.CO = co; g.OH = oh; g.OW = ow; g.padH = padH; g.padW = padW;
    g.TH = (oh + 1) / 2;
    g.TW = (ow + 1) / 2;
    g.segs = (g.TW + TM - 1) / TM;
    g.len = (g.TW + g.segs - 1) / g.segs;
    g.runs = g.segs > 1 ? 1 : (TM / g.TW < RMAX ? TM / g.TW : RMAX);
    g.rows = n * g.TH;
    g.blocks = (g.rows + g.runs - 1) / g.runs * g.segs;

    const long long grid = (long long)g.blocks * (co / BN);
    if (grid > 0x7FFFFFFF)
        return static_cast<int>(cudaErrorInvalidValue);

    cudaError_t err = cudaFuncSetAttribute(winogradF23, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess)
        return static_cast<int>(err);

    winogradF23<<<(unsigned)grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(u), static_cast<bf16*>(y), g);

    return static_cast<int>(cudaGetLastError());
}
