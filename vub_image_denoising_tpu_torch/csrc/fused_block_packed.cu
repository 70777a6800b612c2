// Fused DenoisingBlock on the 2x2 even-packed layout, for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `fused_denoising_block_packed`
// (vub_image_denoising_tpu/ops/fused_block.py:360) and keeps its contract:
// x and y are even-packed (n, h/2, w/2, 4c), packed channel (a*2+b)*c + k
// holding image pixel (2I+a, 2J+b); the block is the one of fused_block.cu,
// so unpack2x2(y) equals kernel 1 on unpack2x2(x).
//
// Design: the packed taps were a TPU device (they fill 128 lanes at c = 32
// and 64, and meet the DMA lane rule) that costs 16/9 of the FLOPs.  Hopper
// has no lane rule, so this kernel addresses the packed layout by index and
// computes the nine 3x3 taps: the halo pyramid of fused_block.cuh with
// PACKED = true, 1.0x the useful FLOPs per position (plus the same halo
// recompute as kernel 1, 1.24x-1.53x), against 16/9 = 1.78x for the packed
// taps.  The tap-major (9, K, N) weights are gathered from the packed ones
// on the device by the wrapper (ops/fused_block.py kernel_weights_from_packed).
// Samples outside the image are zero at every level; with h and w even the
// packed border is exactly the unpacked one.
//
// Bound on an H100 SXM: the same 85.5*c^2*H*W*N FLOP and the same bytes as
// kernel 1, so compute-bound.  This kernel runs on the CUDA cores with f32
// FMA and serves the widths outside TC_WIDTHS (c = 16, 512, ...); at
// c in {32, 64, 128, 256} the wrapper launches fused_block_packed_tc.cu.

#include <cuda_runtime.h>

#include "fused_block.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPositions = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_block_packed_kernel(BlockArgs a) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);
    const int tiles_x = (a.w + a.tw - 1) / a.tw;
    const int y0 = (blockIdx.x / tiles_x) * a.th;
    const int x0 = (blockIdx.x % tiles_x) * a.tw;
    const int b = blockIdx.y;
    for (int level = 0; level < 4; ++level) {
        fb_level<T, kPositions, true>(a, level, y0, x0, b, smem, threadIdx.x, blockDim.x);
        __syncthreads();
    }
}

template <typename T>
int launch(const BlockArgs& a, size_t smem_bytes, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_block_packed_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
    const int tiles = ((a.h + a.th - 1) / a.th) * ((a.w + a.tw - 1) / a.tw);
    dim3 grid(tiles, a.n);
    fused_block_packed_kernel<T><<<grid, kThreads, smem_bytes, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// h, w: the unpacked image size (both even).
extern "C" int fused_block_packed_launch(const void* x, const void* w, const float* ba,
                                         void* y, int n, int h, int w_, int c, int inner,
                                         int th, int tw, int is_bf16, long long smem_bytes,
                                         void* stream) {
    if ((h & 1) || (w_ & 1)) return (int)cudaErrorInvalidValue;
    BlockArgs a{x, w, ba, y, n, h, w_, c, inner, th, tw};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return is_bf16 ? launch<__nv_bfloat16>(a, (size_t)smem_bytes, s)
                   : launch<float>(a, (size_t)smem_bytes, s);
}

extern "C" const char* fused_block_packed_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
