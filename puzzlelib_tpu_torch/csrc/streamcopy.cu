// Streaming probe P3: y = x + 1 elementwise over a contiguous tensor, bf16,
// f16 or f32, the value computed in f32 and rounded once to the type.
//
// Replaces the Pallas TPU kernel tools/roofline_probe.py `copyKernel` (called
// through `pallasCopy`, the `pl.pallas_call` at :78), which streams 64 Mi bf16
// values through VMEM in (4096, 512) blocks to measure the TPU's read + write
// bandwidth.  Here it measures the H100's: one add per element against 4
// bytes moved for bf16, some 0.25 operations per byte, far below the ~295
// the card needs to be bound by anything but device memory.  So the bound is
// the bytes, each input read once and each output written once, over 3.35
// TB/s: 0.0801 ms for 64 Mi bf16 values.
//
// Design: what the TPU's BlockSpec pipeline does (overlap the next block's
// read with this block's write) the card does by having many loads in flight.
// Each thread moves 16 bytes at a time (8 bf16 values), neighbouring threads
// on neighbouring addresses, and issues UNROLL such loads before it adds and
// stores, in a grid-stride loop over the vectors; a tail shorter than one
// vector is done value by value.  No shared memory: nothing is reused.
//
// Entry: pl_streamcopy_add_one(x, y, n, dtype, stream) launches on the
// caller's stream and returns the cudaError_t of cudaGetLastError()
// (cudaErrorInvalidValue for an unknown type).  x and y are 16-byte aligned;
// the caller allocates y.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256, UNROLL = 4;

__device__ __forceinline__ float toFloat(float x) { return x; }
__device__ __forceinline__ float toFloat(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float toFloat(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T fromFloat(float x);

template <>
__device__ __forceinline__ float fromFloat<float>(float x) { return x; }

template <>
__device__ __forceinline__ __nv_bfloat16 fromFloat<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

template <>
__device__ __forceinline__ __half fromFloat<__half>(float x) { return __float2half_rn(x); }

template <typename T>
__device__ __forceinline__ uint4 addOneVec(uint4 v)
{
    constexpr int N = 16 / sizeof(T);
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int i = 0; i < N; ++i)
        e[i] = fromFloat<T>(toFloat(e[i]) + 1.0f);
    return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
addOneKernel(const T* __restrict__ x, T* __restrict__ y, long long n)
{
    constexpr int N = 16 / sizeof(T);
    const long long vecs = n / N;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* yv = reinterpret_cast<uint4*>(y);

    const long long stride = (long long)gridDim.x * THREADS;
    for (long long base = (long long)blockIdx.x * THREADS * UNROLL + threadIdx.x; base < vecs;
         base += stride * UNROLL) {
        uint4 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long i = base + (long long)u * THREADS;
            if (i < vecs)
                v[u] = __ldcs(xv + i);   // streamed: read once, no reuse
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long i = base + (long long)u * THREADS;
            if (i < vecs)
                __stcs(yv + i, addOneVec<T>(v[u]));
        }
    }

    // the tail, shorter than one vector
    const long long i = vecs * N + (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i < n)
        y[i] = fromFloat<T>(toFloat(x[i]) + 1.0f);
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long n, cudaStream_t stream)
{
    constexpr int N = 16 / sizeof(T);
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);

    // enough blocks for every vector once, at most 16 waves of 8 blocks per SM
    const long long perBlock = (long long)THREADS * UNROLL;
    long long blocks = (n / N + perBlock - 1) / perBlock;
    const long long cap = (long long)sms * 8 * 16;
    blocks = blocks < 1 ? 1 : (blocks > cap ? cap : blocks);

    addOneKernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(static_cast<const T*>(x), static_cast<T*>(y), n);
    return cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 f16 (the numbering of matmul.cu)
extern "C" int pl_streamcopy_add_one(const void* x, void* y, long long n, int dtype, void* stream)
{
    const cudaStream_t s = static_cast<cudaStream_t>(stream);

    switch (dtype) {
    case 0:  return launch<float>(x, y, n, s);
    case 1:  return launch<__nv_bfloat16>(x, y, n, s);
    case 2:  return launch<__half>(x, y, n, s);
    default: return cudaErrorInvalidValue;
    }
}
