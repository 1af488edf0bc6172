// Tap-dot probe P1: a stride-1 direct conv as kh * kw shifted-row products in
// pitch layout, bf16 or f16 in, f32 sums, one rounding to the input's type,
// on Hopper's wgmma fed by TMA.
//
// Replaces the Pallas TPU kernel tools/tapdot_probe.py `_kernel` (called
// through `tapdot`, the `pl.pallas_call` at :87, and `conv2d` :118).  The
// input is NHWC with each image's padded (i, j) pairs flattened to rows of
// pitch wp = OW + kw - 1, so filter tap (r, s) is the row shift r wp + s:
//     out[n, g, :] = sum over (r, s) of xp[n, g + r wp + s, :] @ wk[r kw + s]
// for every output row g < mOut = nTiles * bi * wp (the columns j >= OW of
// each pitch row are garbage that the wrapper crops).  On the TPU a program
// holds bi * wp output rows, DMAs its slab of input rows into VMEM (double-
// buffered, with semaphores) and runs kh * kw MXU dots on shifted views of it;
// the probe's question is what Mosaic charges for reads that start off the
// (8, 128) sublane tiling.
//
// What bounds it on the H100: 2 * N * OH * OW * C * CO * kh * kw useful
// operations at 989 TFLOP/s against the input, weights and output moved once
// at 3.35 TB/s: at VGG's conv3_x (C = CO = 256) some 1150 operations per
// byte, far above the ~295 the tensor cores need, so the tensor cores are the
// bound (0.1197 ms at batch 32); the pitch layout adds (kw - 1) / OW of
// wasted rows (4 % at 56).  Behind the tensor cores sits L2: every block
// reads each tap's weight tile once per channel chunk, three quarters of the
// bytes L2 hands out.
//
// Why wgmma can take the shift: the slab sits in shared memory unswizzled
// and K-major, `[channel group of 8][slab row][8 channels]`, 16 bytes a row.
// A warpgroup's m64 tile of A for tap (r, s) and k16 step kk is then one
// shared-memory descriptor without swizzle: start slab + 16 (row + r wp + s)
// + 2 kk LBO, LBO the bytes of one group's run of rows, SBO 128 (the next
// eight rows right behind).  Any row shift is a multiple of 16 bytes on the
// start address, where a 128-byte swizzled tile could be shifted only by
// multiples of 8 rows.  B, the tap's (C, CO) weights, is MN-major and goes
// in as csrc/matmul.cu's B: 128-byte swizzled boxes of 64 output channels,
// the transposed-B form, in the same m64n128k16 instruction.
//
// The kernel (`wg::tapdotWgmma`):
//   - a block owns 256 output rows of one image by 128 output channels: two
//     consumer warpgroups of 128 rows each (two m64n128 f32 sums, 128
//     registers a thread) and one producer warp.  The grid runs the channel
//     blocks fastest, so that the blocks reading one slab run together;
//   - the input channels are walked in chunks of CK = 64 (4 k16 steps a
//     tap), or 32 where two 64-channel slab stages do not fit in shared
//     memory (a launch refuses where two 32-channel ones do not either);
//     each chunk's slab is R = 256 + (kh - 1) wp + kw - 1 rows;
//   - the producer loads by TMA, through two rings with a full and an
//     empty mbarrier a stage: the slab (two stages, one a chunk) and the
//     weight tiles (four stages, one a (chunk, tap)).  The slab's tensor
//     map is 3-D over (C, rows, N) with boxes of 8 channels by at most 256
//     rows (TMA's largest box); each group's run of R rows is cut into
//     equal boxes of a multiple of 8 rows, each landing at its place in the
//     run, so that a shifted tile never reads across two regions.  The
//     weights' map is 3-D over (CO, C, taps) with boxes of 64 by CK, so that
//     a tap's box never reads the next tap's rows.  TMA fills zeros past an
//     image's rows, past C and past CO, and counts them in the bytes a
//     barrier expects: every chunk runs its CK / 16 k16 steps whole, and
//     channel groups past C add zeros (skipping their steps instead put a
//     branch around the products, into which ptxas injects warpgroup
//     arrives, and measured slower at every timed shape);
//   - a consumer releases a weight stage once the products that read it
//     have retired (`wgmma.wait_group 1` one step later), and a slab stage
//     when its chunk's last tap's have;
//   - the first product of a sum starts it with scale-d 0 (so ptxas keeps
//     the products asynchronous), the warp index comes from lane 0 (uniform
//     for ptxas), and the sums go from the registers to device memory as
//     bf16 or f16 pairs, masked at mOut and CO.
// Bytes from L2 at VGG's conv3_x at batch 32: 832 blocks each read 4
// chunks x 9 taps x 16 KB of weights (0.49 GB) and 4 slabs of 384 rows
// (374 in two boxes of 192) x 128 bytes (0.16 GB), some 0.65 GB a call
// against the first kernel's ~1.2.
// 128-row blocks (one m64 tile a warpgroup, two blocks an SM) measured
// slower at every timed shape.
//
// The first kernel (`mmaSync::tapdotMma`: mma.sync m16n8k16 fed by
// ldmatrix, eight warps of 64 rows x 32 channels, 32-channel chunks staged
// by cp.async, two stages) stays below under its own path as the yardstick
// the new kernel is timed and checked against; `tapdot` never takes it.
//
// Types: bf16 and f16; C and CO multiples of 16.  f32 is refused by the
// wrapper: Hopper's tensor cores have no f32 mode.
//
// Entries: pl_tapdot(xp, wk, out, n, rowsX, mOut, c, co, wp, kh, kw, dtype,
// path, stream) launches the kernel of `path` (0 wgmma, 1 mma.sync) on the
// caller's stream and returns the cudaError_t of cudaGetLastError()
// (cudaErrorInvalidValue for a type or path it has no instance for, or a
// slab too tall for shared memory).  The caller allocates out (n, mOut, co),
// passes 16-byte aligned operands and guarantees rowsX >= mOut + (kh - 1) wp
// + kw - 1.  pl_tapdot_smem(wp, kh, kw, chunk) gives the dynamic shared
// memory of a wgmma launch and writes its channel chunk to *chunk (both 0
// where it refuses).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <type_traits>

namespace {

// the kernels of pl_tapdot
enum Path { PATH_WGMMA = 0, PATH_MMA = 1 };

__device__ __forceinline__ uint32_t smemAddr(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cpAsync16(void* smem, const void* gmem, bool valid)
{
    // src-size 0 fills the 16 bytes with zeros and reads nothing
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smemAddr(smem)), "l"(gmem),
                 "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cpAsyncCommit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cpAsyncWaitAll()
{
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// the most dynamic shared memory a block may opt in to on this card
int maxSmem()
{
    int device = 0, optin = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    return optin;
}

// the opt-in of an instance, once (above 48 KB a launch needs it)
template <typename Kernel>
cudaError_t optIn(Kernel kernel, int& optin)
{
    if (optin != 0)
        return cudaSuccess;

    optin = maxSmem();
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess)
        optin = 0;
    return err;
}

// -- the first kernel, mma.sync (the yardstick) ---------------------------------

namespace mmaSync {

constexpr int BM = 128, BN = 128, CK = 32, THREADS = 256;
constexpr int SP = CK + 8;       // slab pitch in elements, 80 bytes: ldmatrix rows hit distinct banks
constexpr int WPITCH = BN + 8;   // weight tile pitch, 272 bytes: likewise

__device__ __forceinline__ void ldmatrixX4(uint32_t (&r)[4], const void* smem)
{
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smemAddr(smem)));
}

__device__ __forceinline__ void ldmatrixX4Trans(uint32_t (&r)[4], const void* smem)
{
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smemAddr(smem)));
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

// one block of 8 warps per (128 output rows, 128 output channels, image);
// each warp owns 64 rows by 32 channels.  Every (32-channel chunk, tap) step
// stages its weight tile, and every chunk its slab, by cp.async, double-
// buffered; A by ldmatrix from the slab shifted by the tap's rows
template <typename T>
__global__ void __launch_bounds__(THREADS)
tapdotMma(const T* __restrict__ xp, const T* __restrict__ wk, T* __restrict__ out, int rowsX, int mOut, int c,
          int co, int wp, int kh, int kw, int slabRows)
{
    extern __shared__ __align__(128) unsigned char smem[];
    T* slab = reinterpret_cast<T*>(smem);      // 2 stages of (slabRows, SP)
    T* wt = slab + 2 * slabRows * SP;          // 2 stages of (CK, WPITCH)

    const int g0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wm = warp >> 2, wn = warp & 3;   // 2 x 4 warps of 64 rows x 32 channels

    const T* x = xp + (size_t)blockIdx.z * rowsX * c;
    const int taps = kh * kw, chunks = (c + CK - 1) / CK, steps = chunks * taps;

    // rows [g0, g0 + slabRows) of the image, channels [k0, k0 + CK)
    auto loadSlab = [&](int stage, int k0) {
        T* dst = slab + stage * slabRows * SP;
        for (int v = tid; v < slabRows * (CK / 8); v += THREADS) {
            const int r = v / (CK / 8), ch = (v % (CK / 8)) * 8;
            const bool ok = g0 + r < rowsX && k0 + ch < c;
            cpAsync16(dst + r * SP + ch, ok ? x + (size_t)(g0 + r) * c + k0 + ch : x, ok);
        }
    };

    // rows [k0, k0 + CK) and columns [n0, n0 + BN) of tap `tap`'s (C, CO) filter
    auto loadWeights = [&](int stage, int tap, int k0) {
        T* dst = wt + stage * CK * WPITCH;
        const T* src = wk + (size_t)tap * c * co;
        for (int v = tid; v < CK * (BN / 8); v += THREADS) {
            const int r = v / (BN / 8), col = (v % (BN / 8)) * 8;
            const bool ok = k0 + r < c && n0 + col < co;
            cpAsync16(dst + r * WPITCH + col, ok ? src + (size_t)(k0 + r) * co + n0 + col : src, ok);
        }
    };

    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                acc[mi][t][e] = 0.0f;

    loadSlab(0, 0);
    loadWeights(0, 0, 0);
    cpAsyncCommit();

    for (int i = 0; i < steps; ++i) {
        const int chunk = i / taps, tap = i % taps;

        cpAsyncWaitAll();   // step i's slab and weights have landed
        __syncthreads();    // ... for every thread, and step i - 1's are consumed

        if (i + 1 < steps)
            loadWeights((i + 1) & 1, (i + 1) % taps, ((i + 1) / taps) * CK);
        if (tap == 0 && chunk + 1 < chunks)
            loadSlab((chunk + 1) & 1, (chunk + 1) * CK);
        cpAsyncCommit();

        // this tap's A operand: the slab shifted down by r wp + s rows
        const int shift = (tap / kw) * wp + tap % kw;
        const T* a = slab + (chunk & 1) * slabRows * SP + (wm * 64 + shift) * SP;
        const T* b = wt + (i & 1) * CK * WPITCH + wn * 32;

#pragma unroll
        for (int kk = 0; kk < CK / 16; ++kk) {
            uint32_t af[4][4];
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
                ldmatrixX4(af[mi], a + (mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SP + kk * 16 + (lane >> 4) * 8);

#pragma unroll
            for (int t = 0; t < 4; t += 2) {
                uint32_t bf[4];
                ldmatrixX4Trans(bf, b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * WPITCH + t * 8 +
                                        (lane >> 4) * 8);
#pragma unroll
                for (int mi = 0; mi < 4; ++mi) {
                    mma<T>(acc[mi][t], af[mi], bf[0], bf[1]);
                    mma<T>(acc[mi][t + 1], af[mi], bf[2], bf[3]);
                }
            }
        }
    }

    cpAsyncWaitAll();

    T* o = out + (size_t)blockIdx.z * mOut * co;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            const int col = n0 + wn * 32 + t * 8 + (lane & 3) * 2;
            if (col >= co)
                continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = g0 + wm * 64 + mi * 16 + (lane >> 2) + h * 8;
                if (row < mOut)
                    *reinterpret_cast<uint32_t*>(o + (size_t)row * co + col) =
                        pack2<T>(acc[mi][t][2 * h], acc[mi][t][2 * h + 1]);
            }
        }
}

size_t smemBytes(int wp, int kh, int kw)
{
    const int slabRows = BM + (kh - 1) * wp + kw - 1;
    return (2 * (size_t)slabRows * SP + 2 * CK * WPITCH) * 2;
}

template <typename T>
cudaError_t launch(const void* xp, const void* wk, void* out, int n, int rowsX, int mOut, int c, int co, int wp,
                   int kh, int kw, cudaStream_t stream)
{
    static int optin = 0;
    const cudaError_t err = optIn(tapdotMma<T>, optin);
    if (err != cudaSuccess)
        return err;

    const size_t bytes = smemBytes(wp, kh, kw);
    if (bytes > (size_t)optin)
        return cudaErrorInvalidValue;

    const dim3 grid((mOut + BM - 1) / BM, (co + BN - 1) / BN, n);
    tapdotMma<T><<<grid, THREADS, bytes, stream>>>(static_cast<const T*>(xp), static_cast<const T*>(wk),
                                                  static_cast<T*>(out), rowsX, mOut, c, co, wp, kh, kw,
                                                  BM + (kh - 1) * wp + kw - 1);
    return cudaGetLastError();
}

}  // namespace mmaSync

// -- wgmma's parts ---------------------------------------------------------------

constexpr int SWIZZLE = 1024;   // the 128-byte swizzle repeats every eight rows of 128 bytes

// a shared-memory matrix descriptor without swizzle: the slab's K-major A,
// core matrices of 8 rows x 16 bytes, `lbo` bytes apart along K (a channel
// group's run of rows) and 128 along M (the next eight rows)
__device__ __forceinline__ uint64_t plainDesc(uint32_t addr, int lbo)
{
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(128 >> 4) << 32);
}

// a shared-memory matrix descriptor of a 128-byte swizzled tile (SBO 1024
// bytes, eight 128-byte rows): the MN-major weights, LBO the bytes between
// their boxes of 64 output channels
__device__ __forceinline__ uint64_t swizzled(uint32_t addr, int lbo)
{
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(SWIZZLE >> 4) << 32) |
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
// compiler neither reads them before the wait for the products nor moves
// their other uses across it
__device__ __forceinline__ void fenceSum(float (&acc)[64])
{
#pragma unroll
    for (int i = 0; i < 64; ++i)
        asm volatile("" : "+f"(acc[i])::"memory");
}

// a warpgroup's m64n128 sum to device memory as pairs of T: thread (warp w
// of its warpgroup, lane l) holds rows 16 w + l / 4 (h = 0) and + 8 (h = 1),
// columns 8 j + 2 (l % 4) and + 1, acc[4 j + 2 h] and + 1.  CO is a
// multiple of 16, so a pair is wholly inside or outside
template <typename T>
__device__ __forceinline__ void storeSum(T* o, const float (&acc)[64], int row0, int n0, int mOut, int co, int w,
                                         int l)
{
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int gm = row0 + 16 * w + l / 4 + 8 * h;
        if (gm >= mOut)
            continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int gn = n0 + 8 * j + 2 * (l & 3);
            if (gn < co)
                *reinterpret_cast<uint32_t*>(o + (size_t)gm * co + gn) = pack2<T>(acc[4 * j + 2 * h],
                                                                                 acc[4 * j + 2 * h + 1]);
        }
    }
}

// -- the kernel: wgmma fed by TMA ------------------------------------------------

namespace wg {

constexpr int WG_ROWS = 128;            // a consumer warpgroup's output rows: two m64 tiles
constexpr int BM = 2 * WG_ROWS, BN = 128;
constexpr int THREADS = 2 * 128 + 32;   // two consumer warpgroups and a producer warp
constexpr int W_STAGES = 4, S_STAGES = 2;
constexpr int MAX_BOX_ROWS = 256;       // TMA's largest box dimension

// a TMA box of weights: CK rows of 64 output channels, 128 bytes a row
template <int CK>
__host__ __device__ constexpr int wBox() { return CK * 128; }

// how a group's run of R slab rows is cut into TMA boxes: `boxes` of
// `boxRows` rows each (a multiple of 8, so every box starts on 128 bytes),
// `run` = boxes * boxRows >= R rows between the groups
struct Slab {
    int boxes, boxRows, run;
};

__host__ __device__ inline Slab slabOf(int wp, int kh, int kw)
{
    const int rows = BM + (kh - 1) * wp + kw - 1;
    const int boxes = (rows + MAX_BOX_ROWS - 1) / MAX_BOX_ROWS;
    const int boxRows = ((rows + boxes - 1) / boxes + 7) / 8 * 8;
    return {boxes, boxRows, boxes * boxRows};
}

// the ring's bytes: weight stages, slab stages, their full and empty
// barriers, and room to align the weights to the swizzle's period
inline size_t smemBytes(int ck, const Slab& sl)
{
    return W_STAGES * 2 * (size_t)ck * 128 + S_STAGES * (size_t)(ck / 8) * sl.run * 16 +
           2 * (W_STAGES + S_STAGES) * 8 + SWIZZLE;
}

// the channel chunk a launch takes: 64, or 32 where two 64-channel slab
// stages do not fit, or 0 where neither does
inline int chunkOf(int wp, int kh, int kw, int optin)
{
    const Slab sl = slabOf(wp, kh, kw);
    if (smemBytes(64, sl) <= (size_t)optin)
        return 64;
    if (smemBytes(32, sl) <= (size_t)optin)
        return 32;
    return 0;
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

// one box of a 3-D `map` at (c0, c1, c2), innermost first, into dst,
// counted on bar; TMA writes zeros where the box leaves the tensor
__device__ __forceinline__ void tmaLoad(void* dst, const CUtensorMap* map, int c0, int c1, int c2, uint64_t* bar)
{
    asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smemAddr(dst)),
                 "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smemAddr(bar))
                 : "memory");
}

// one (256 output rows of image blockIdx.z, 128 output channels) tile.
// Warps 0 .. 7 are the consumer warpgroups, warp 8 the producer
template <typename T, int CK>
__global__ void __launch_bounds__(THREADS, 1)
tapdotWgmma(const __grid_constant__ CUtensorMap mapX, const __grid_constant__ CUtensorMap mapW, T* __restrict__ out,
            int mOut, int c, int co, int wp, int kw, int taps, int boxes, int boxRows)
{
    constexpr int W_BOX = wBox<CK>(), W_STAGE = 2 * W_BOX;
    extern __shared__ __align__(128) unsigned char smemRaw[];
    unsigned char* const smem = smemRaw + ((SWIZZLE - (smemAddr(smemRaw) & (SWIZZLE - 1))) & (SWIZZLE - 1));
    const int run = boxes * boxRows, lbo = run * 16, slabStage = (CK / 8) * lbo;
    unsigned char* const wRing = smem;
    unsigned char* const sRing = smem + W_STAGES * W_STAGE;
    uint64_t* const wFull = reinterpret_cast<uint64_t*>(sRing + S_STAGES * slabStage);
    uint64_t* const wEmpty = wFull + W_STAGES;
    uint64_t* const sFull = wEmpty + W_STAGES;
    uint64_t* const sEmpty = sFull + S_STAGES;

    const int n0 = blockIdx.x * BN, g0 = blockIdx.y * BM, img = blockIdx.z;
    const int tid = threadIdx.x, lane = tid & 31;
    const int warp = __shfl_sync(0xFFFFFFFFu, tid >> 5, 0);   // uniform: ptxas keeps the products asynchronous
    const int chunks = (c + CK - 1) / CK;

    if (tid == 0) {
        for (int s = 0; s < W_STAGES; ++s) {
            barInit(&wFull[s], 1);
            barInit(&wEmpty[s], 8);   // lane 0 of every consumer warp
        }
        for (int s = 0; s < S_STAGES; ++s) {
            barInit(&sFull[s], 1);
            barInit(&sEmpty[s], 8);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == 8) {
        // the producer: one thread keeps both rings full.  A box of weights
        // wholly right of CO is not loaded; the slab's channel groups past C
        // are (TMA's zeros, so that every chunk runs CK / 16 whole k16 steps)
        if (lane == 0) {
            const bool second = n0 + 64 < co;
            const unsigned wBytes = (second ? 2 : 1) * W_BOX;
            for (int ch = 0, i = 0; ch < chunks; ++ch) {
                const int k0 = ch * CK, s = ch & 1;
                if (ch >= S_STAGES)
                    barWait(&sEmpty[s], ((ch >> 1) - 1) & 1);

                unsigned char* const st = sRing + s * slabStage;
                barExpect(&sFull[s], slabStage);
                for (int g = 0; g < CK / 8; ++g)
                    for (int b = 0; b < boxes; ++b)
                        tmaLoad(st + g * lbo + b * boxRows * 16, &mapX, k0 + 8 * g, g0 + b * boxRows, img, &sFull[s]);

                for (int tap = 0; tap < taps; ++tap, ++i) {
                    const int w = i % W_STAGES;
                    if (i >= W_STAGES)
                        barWait(&wEmpty[w], (i / W_STAGES - 1) & 1);

                    unsigned char* const ws = wRing + w * W_STAGE;
                    barExpect(&wFull[w], wBytes);
                    tmaLoad(ws, &mapW, n0, k0, tap, &wFull[w]);
                    if (second)
                        tmaLoad(ws + W_BOX, &mapW, n0 + 64, k0, tap, &wFull[w]);
                }
            }
        }
        return;
    }

    // a consumer warpgroup: rows 128 wg .. 128 wg + 127 of the tile, as two
    // m64 sums; A of tap (r, s) the slab shifted down by r wp + s rows, k16
    // step kk two groups (2 LBO) on; B k16 step kk 16 rows of 128 bytes on,
    // its second 64 columns one box on (LBO)
    const int wg = warp >> 2;
    float acc[2][64];   // each set by its first product
    const uint32_t wBase = smemAddr(wRing), sBase = smemAddr(sRing) + 16 * WG_ROWS * wg;

    for (int ch = 0, i = 0; ch < chunks; ++ch) {
        const int s = ch & 1;
        barWait(&sFull[s], (ch >> 1) & 1);
        const uint32_t slab = sBase + s * slabStage;

        for (int tap = 0; tap < taps; ++tap, ++i) {
            const int w = i % W_STAGES;
            barWait(&wFull[w], (i / W_STAGES) & 1);

            const uint32_t a = slab + 16 * ((tap / kw) * wp + tap % kw);
            const uint32_t b = wBase + w * W_STAGE;
            wgmmaFence();
#pragma unroll
            for (int kk = 0; kk < CK / 16; ++kk) {
                const uint64_t db = swizzled(b + 16 * 128 * kk, W_BOX);
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
                    wgmma<T>(acc[mt], plainDesc(a + 16 * 64 * mt + 2 * kk * lbo, lbo), db, i > 0 || kk > 0);
            }
            wgmmaCommit();
            wgmmaWait<1>();

            // step i - 1's products have retired: its weight stage is free,
            // and at a chunk's first tap the last chunk's slab
            if (i > 0 && lane == 0) {
                barArrive(&wEmpty[(i - 1) % W_STAGES]);
                if (tap == 0)
                    barArrive(&sEmpty[(ch - 1) & 1]);
            }
        }
    }
    wgmmaWait<0>();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
        fenceSum(acc[mt]);

    T* const o = out + (size_t)img * mOut * co;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
        storeSum<T>(o, acc[mt], g0 + WG_ROWS * wg + 64 * mt, n0, mOut, co, warp & 3, lane);
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

// a 3-D tensor of 16-bit values, dims innermost first, rows of dims[0]
// values, as TMA reads it in boxes of `box`; zeros outside the tensor
template <typename T>
bool tensorMap(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[3], const cuuint32_t (&box)[3],
               CUtensorMapSwizzle swizzle)
{
    static const EncodeTiled encode = findEncoder();
    if (encode == nullptr)
        return false;

    const CUtensorMapDataType type =
        std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const cuuint64_t strides[2] = {dims[0] * 2, dims[0] * dims[1] * 2};
    const cuuint32_t steps[3] = {1, 1, 1};
    return encode(map, type, 3, const_cast<void*>(base), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int CK>
cudaError_t launchChunk(const void* xp, const void* wk, void* out, int n, int rowsX, int mOut, int c, int co, int wp,
                        int kh, int kw, const Slab& sl, size_t bytes, cudaStream_t stream)
{
    static int optin = 0;
    const cudaError_t err = optIn(tapdotWgmma<T, CK>, optin);
    if (err != cudaSuccess)
        return err;

    // the slab: (C, rows, N) in boxes of 8 channels by boxRows rows; the
    // weights: (CO, C, taps) in 128-byte swizzled boxes of 64 by CK
    CUtensorMap mapX, mapW;
    if (!tensorMap<T>(&mapX, xp, {(cuuint64_t)c, (cuuint64_t)rowsX, (cuuint64_t)n},
                      {8, (cuuint32_t)sl.boxRows, 1}, CU_TENSOR_MAP_SWIZZLE_NONE) ||
        !tensorMap<T>(&mapW, wk, {(cuuint64_t)co, (cuuint64_t)c, (cuuint64_t)(kh * kw)}, {64, CK, 1},
                      CU_TENSOR_MAP_SWIZZLE_128B))
        return cudaErrorInvalidValue;

    const dim3 grid((co + BN - 1) / BN, (mOut + BM - 1) / BM, n);
    tapdotWgmma<T, CK><<<grid, THREADS, bytes, stream>>>(mapX, mapW, static_cast<T*>(out), mOut, c, co, wp, kw,
                                                         kh * kw, sl.boxes, sl.boxRows);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* xp, const void* wk, void* out, int n, int rowsX, int mOut, int c, int co, int wp,
                   int kh, int kw, cudaStream_t stream)
{
    const Slab sl = slabOf(wp, kh, kw);
    switch (chunkOf(wp, kh, kw, maxSmem())) {
    case 64:
        return launchChunk<T, 64>(xp, wk, out, n, rowsX, mOut, c, co, wp, kh, kw, sl, smemBytes(64, sl), stream);
    case 32:
        return launchChunk<T, 32>(xp, wk, out, n, rowsX, mOut, c, co, wp, kh, kw, sl, smemBytes(32, sl), stream);
    default:
        return cudaErrorInvalidValue;
    }
}

}  // namespace wg

template <typename T>
cudaError_t launch(const void* xp, const void* wk, void* out, int n, int rowsX, int mOut, int c, int co, int wp,
                   int kh, int kw, int path, cudaStream_t stream)
{
    switch (path) {
    case PATH_WGMMA: return wg::launch<T>(xp, wk, out, n, rowsX, mOut, c, co, wp, kh, kw, stream);
    case PATH_MMA:   return mmaSync::launch<T>(xp, wk, out, n, rowsX, mOut, c, co, wp, kh, kw, stream);
    default:         return cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 1 bf16, 2 f16 (the numbering of matmul.cu; 0, f32, has no instance)
extern "C" int pl_tapdot(const void* xp, const void* wk, void* out, int n, int rowsX, int mOut, int c, int co,
                         int wp, int kh, int kw, int dtype, int path, void* stream)
{
    const cudaStream_t s = static_cast<cudaStream_t>(stream);

    switch (dtype) {
    case 1:  return launch<__nv_bfloat16>(xp, wk, out, n, rowsX, mOut, c, co, wp, kh, kw, path, s);
    case 2:  return launch<__half>(xp, wk, out, n, rowsX, mOut, c, co, wp, kh, kw, path, s);
    default: return cudaErrorInvalidValue;
    }
}

extern "C" int pl_tapdot_smem(int wp, int kh, int kw, int* chunk)
{
    *chunk = wg::chunkOf(wp, kh, kw, maxSmem());
    return *chunk == 0 ? 0 : (int)wg::smemBytes(*chunk, wg::slabOf(wp, kh, kw));
}
