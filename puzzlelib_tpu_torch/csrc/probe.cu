// Install probe K0: y = 2 x elementwise, f32.
//
// Replaces the Pallas TPU kernel puzzlelib_tpu/checkinstall.py `kernel`
// (the `pl.pallas_call` at :41), which doubles one (8, 128) f32 block to show
// that a kernel compiles and runs on the device.  Here it shows that nvcc
// built a library for sm_90a, that ctypes loaded it and that a launch on
// PyTorch's stream ran: one thread per element, a grid-stride loop.  Bound on
// the H100 by its launch (a few microseconds); at the probe's 4 KB, reading
// and writing the block takes nanoseconds.
//
// Entry: pl_probe_double(x, y, n, stream) launches and returns the
// cudaError_t of cudaGetLastError().  The caller allocates y.

#include <cuda_runtime.h>

namespace {

__global__ void doubleKernel(const float* __restrict__ x, float* __restrict__ y, long long n)
{
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x)
        y[i] = x[i] * 2.0f;
}

}  // namespace

extern "C" int pl_probe_double(const void* x, void* y, long long n, void* stream)
{
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;

    doubleKernel<<<(unsigned)(blocks < 1024 ? (blocks > 0 ? blocks : 1) : 1024), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(x), static_cast<float*>(y), n);
    return static_cast<int>(cudaGetLastError());
}
