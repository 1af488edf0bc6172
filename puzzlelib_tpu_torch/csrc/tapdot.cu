// Tap-dot probe P1: a stride-1 direct conv as kh * kw shifted-row products in
// pitch layout, bf16 or f16 in, f32 sums, one rounding to the input's type.
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
// (8, 128) sublane tiling.  Here that question does not arise: the slab sits
// in shared memory one channel row per pitch row, every row starting on a
// 16-byte boundary, and `ldmatrix` reads an A fragment from any such row, so
// a shift by r wp + s rows costs nothing.
//
// What bounds it on the H100: 2 * N * OH * OW * C * CO * kh * kw useful
// operations at 989 TFLOP/s against the input, weights and output moved once
// at 3.35 TB/s: at VGG's conv3_x (C = CO = 256) some 1150 operations per
// byte, far above the ~295 the tensor cores need, so the tensor cores are the
// bound (0.1197 ms at batch 32); the pitch layout adds (kw - 1) / OW of
// wasted rows (4 % at 56).  This first version is simple:
//   - one block of 8 warps per (128 output rows, 128 output channels, image);
//     each warp owns 64 rows by 32 channels, 16 (16 x 8) f32 accumulators;
//   - the channels are walked in chunks of 32; for each chunk the block
//     stages its slab of 128 + (kh - 1) wp + kw - 1 input rows by 32 channels
//     in shared memory by cp.async, double-buffered, the next chunk's slab
//     issued while this chunk's first tap runs;
//   - each (chunk, tap) step stages that tap's (32, 128) weight tile, double-
//     buffered, and runs 2 k16 steps of mma.sync m16n8k16 (bf16 or f16 in,
//     f32 accumulators) with A read by ldmatrix from the slab shifted by the
//     tap's rows and B by ldmatrix.trans from the weight tile;
//   - channel and row edges are zero-filled by cp.async (src-size 0), output
//     rows past mOut and channels past CO are not stored.
// wgmma, TMA, a deeper ring and warp specialisation are the later steps.
//
// Types: bf16 and f16; C and CO multiples of 16.  f32 is refused by the
// wrapper: Hopper's tensor cores have no f32 mode.
//
// Entry: pl_tapdot(xp, wk, out, n, rowsX, mOut, c, co, wp, kh, kw, dtype,
// stream) launches on the caller's stream and returns the cudaError_t of
// cudaGetLastError() (cudaErrorInvalidValue for a type it has no instance
// for, or a slab too tall for shared memory).  The caller allocates out (n,
// mOut, co) and guarantees rowsX >= mOut + (kh - 1) wp + kw - 1.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, CK = 32, THREADS = 256;
constexpr int SP = CK + 8;   // slab pitch in elements, 80 bytes: ldmatrix rows hit distinct banks
constexpr int WPITCH = BN + 8;   // weight tile pitch, 272 bytes: likewise

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
tapdotKernel(const T* __restrict__ xp, const T* __restrict__ wk, T* __restrict__ out, int rowsX, int mOut, int c,
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

template <typename T>
cudaError_t launch(const void* xp, const void* wk, void* out, int n, int rowsX, int mOut, int c, int co, int wp,
                   int kh, int kw, cudaStream_t stream)
{
    const int slabRows = BM + (kh - 1) * wp + kw - 1;
    const size_t bytes = (2 * (size_t)slabRows * SP + 2 * CK * WPITCH) * sizeof(T);

    static int optin = 0;   // once per instance: above 48 KB needs the opt-in
    if (optin == 0) {
        int device = 0;
        cudaGetDevice(&device);
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
        const cudaError_t err = cudaFuncSetAttribute(tapdotKernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                     optin);
        if (err != cudaSuccess) {
            optin = 0;
            return err;
        }
    }
    if (bytes > (size_t)optin)
        return cudaErrorInvalidValue;

    const dim3 grid((mOut + BM - 1) / BM, (co + BN - 1) / BN, n);
    tapdotKernel<T><<<grid, THREADS, bytes, stream>>>(static_cast<const T*>(xp), static_cast<const T*>(wk),
                                                     static_cast<T*>(out), rowsX, mOut, c, co, wp, kh, kw, slabRows);
    return cudaGetLastError();
}

}  // namespace

// dtype: 1 bf16, 2 f16 (the numbering of matmul.cu; 0, f32, has no instance)
extern "C" int pl_tapdot(const void* xp, const void* wk, void* out, int n, int rowsX, int mOut, int c, int co,
                         int wp, int kh, int kw, int dtype, void* stream)
{
    const cudaStream_t s = static_cast<cudaStream_t>(stream);

    switch (dtype) {
    case 1:  return launch<__nv_bfloat16>(xp, wk, out, n, rowsX, mOut, c, co, wp, kh, kw, s);
    case 2:  return launch<__half>(xp, wk, out, n, rowsX, mOut, c, co, wp, kh, kw, s);
    default: return cudaErrorInvalidValue;
    }
}
