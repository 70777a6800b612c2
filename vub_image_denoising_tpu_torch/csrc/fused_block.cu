// Fused DenoisingBlock for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `fused_denoising_block`
// (vub_image_denoising_tpu/ops/fused_block.py:193).  It computes
//   o0 = PReLU(conv0(x)), o1 = PReLU(conv1([x,o0])), o2 = PReLU(conv2([x,o0,o1])),
//   y  = PReLU(conv3([x,o0,o1,o2])) + x
// with every conv 3x3 SAME, and keeps o0..o2 out of device memory (shared
// memory only), as the TPU kernel keeps them in VMEM.
//
// Bound on an H100 SXM: 85.5*c^2*H*W*N FLOP per launch (5.74 GFLOP per 256^2
// image at c = 32), against 2*N*H*W*c*sizeof(T) bytes of x and y: at c = 32,
// batch 8 that is ~46 us of bf16 tensor-core time (989 TFLOP/s) against ~20 us
// of bytes (3.35 TB/s), so the block is compute-bound at every scale.
//
// This first version runs the convs on CUDA cores with f32 FMA (no tensor
// cores), which is what exact-f32 parity needs and bf16 accepts; the halo
// recompute costs 1.24x (16x16 tiles) to 1.53x (8x8) of the block's FLOPs,
// 2.29x for the 4x4 tile of f32 at c = 256.
// The math is in fused_block.cuh.

#include <cuda_runtime.h>

#include "fused_block.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPositions = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_block_kernel(BlockArgs a) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);
    const int tiles_x = (a.w + a.tw - 1) / a.tw;
    const int y0 = (blockIdx.x / tiles_x) * a.th;
    const int x0 = (blockIdx.x % tiles_x) * a.tw;
    const int b = blockIdx.y;
    for (int level = 0; level < 4; ++level) {
        fb_level<T, kPositions, false>(a, level, y0, x0, b, smem, threadIdx.x, blockDim.x);
        __syncthreads();
    }
}

template <typename T>
int launch(const BlockArgs& a, size_t smem_bytes, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
    const int tiles = ((a.h + a.th - 1) / a.th) * ((a.w + a.tw - 1) / a.tw);
    dim3 grid(tiles, a.n);
    fused_block_kernel<T><<<grid, kThreads, smem_bytes, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_block_launch(const void* x, const void* w, const float* ba, void* y,
                                  int n, int h, int w_, int c, int inner, int th, int tw,
                                  int is_bf16, long long smem_bytes, void* stream) {
    BlockArgs a{x, w, ba, y, n, h, w_, c, inner, th, tw};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return is_bf16 ? launch<__nv_bfloat16>(a, (size_t)smem_bytes, s)
                   : launch<float>(a, (size_t)smem_bytes, s);
}

extern "C" const char* fused_block_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
