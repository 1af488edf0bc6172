// Strided-copy probe P2: the four stride-2 phase slabs of an NHWC image.
//
// Replaces the Pallas TPU kernel tools/strided_dma_probe.py `_kernel` (called
// through `phaseSplit`, the `pl.pallas_call` at :58).  With x6 the free
// reshape (N, H/2, 2, W/2, 2, C) of an NHWC image, it copies
//     out[t, 2 ap + bp, r, j, :] = x6[0, t rows + r, ap, j, bp, :]
// for every tile t < nTiles, phase (ap, bp), tile row r < rows and column j <
// W/2: batch 0 only, as the TPU kernel reads `xRef.at[0, ...]`.  The TPU
// kernel asks whether Mosaic's DMA engine can walk such a strided pattern and
// at what bandwidth, with two slots of VMEM and a semaphore per phase to
// overlap the next tile's four copies with this tile's write-back.
//
// What bounds it on the H100: nothing but the bytes (no arithmetic), each
// input byte read once and each output byte written once over 3.35 TB/s.
// Every run of C values is contiguous in both layouts, so the copy is a plain
// gather of C-value rows: each thread moves 16 bytes, neighbouring threads on
// neighbouring bytes of a row, and consecutive threads walk consecutive rows
// of the output, so the stores are fully coalesced and the loads coalesced
// within each C-value row.  The TPU's double buffer and semaphores have no
// use here: the card keeps many loads in flight across its warps.
//
// Entry: pl_phase_split(x6, out, tw, rowBytes, rows, nTiles, stream) launches
// on the caller's stream and returns the cudaError_t of cudaGetLastError()
// (cudaErrorInvalidValue for a copy of 2^31 16-byte units or more).
// rowBytes, C times the element size, is a multiple of 16, both operands are
// 16-byte aligned, and the caller allocates out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
phaseSplitKernel(const uint4* __restrict__ x6, uint4* __restrict__ out, unsigned tw, unsigned rowUnits, unsigned rows,
                 unsigned total)
{
    // 32-bit index arithmetic (the wrapper keeps the copy below 2^31 units):
    // the divisions are the kernel's only work besides the copy
    for (unsigned i = blockIdx.x * THREADS + threadIdx.x; i < total; i += gridDim.x * THREADS) {
        // the output index (t, p, r, j, u), u the unit within a C-value row
        const unsigned u = i % rowUnits;
        unsigned rest = i / rowUnits;
        const unsigned j = rest % tw;
        rest /= tw;
        const unsigned r = rest % rows;
        rest /= rows;
        const unsigned p = rest % 4, t = rest / 4;

        const unsigned ap = p >> 1, bp = p & 1;
        const unsigned row = t * rows + r;   // of x6[0]'s H/2 rows

        out[i] = x6[(((row * 2 + ap) * tw + j) * 2 + bp) * rowUnits + u];
    }
}

}  // namespace

extern "C" int pl_phase_split(const void* x6, void* out, int tw, long long rowBytes, int rows, int nTiles,
                              void* stream)
{
    const long long rowUnits = rowBytes / 16;
    const long long total = (long long)nTiles * 4 * rows * tw * rowUnits;
    if (total == 0)
        return static_cast<int>(cudaSuccess);
    if (total >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);

    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);

    long long blocks = (total + THREADS - 1) / THREADS;
    const long long cap = (long long)sms * 8 * 32;
    blocks = blocks > cap ? cap : blocks;

    phaseSplitKernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(x6), static_cast<uint4*>(out), (unsigned)tw, (unsigned)rowUnits, (unsigned)rows,
        (unsigned)total);
    return static_cast<int>(cudaGetLastError());
}
