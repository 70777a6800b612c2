// Fused DenoisingBlock for Hopper (sm_90a) on the tensor cores, NHWC, in
// bf16 and in f32; plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `fused_denoising_block`
// (vub_image_denoising_tpu/ops/fused_block.py:193) for bf16 and f32 inputs
// with c in {32, 64, 128, 256}; other widths stay on the CUDA-core kernel
// (fused_block.cu).  The kernel is the body of fused_block_tc.cuh with
// PACKED = false; its head comment has the design.
//
// Bound on an H100 SXM: 85.5*c^2*H*W*N FLOP per launch (45.9 GFLOP for every
// RDUNet-32 block at batch 8, 256^2).  bf16: 46 us at the 989 TFLOP/s dense
// peak.  f32: three products each, 3 x 45.9 GFLOP at the 494.7 TFLOP/s dense
// TF32 peak, 0.278 ms (the CUDA cores' 67 TFLOP/s f32 FMA would need
// 0.685 ms).  The bytes of x and y take ~20 us (bf16) or ~40 us (f32), so
// operations bound it and the products go to the tensor cores.

#include "fused_block_tc.cuh"

// Every (T, c, th, tw) that ops/fused_block.py TC_TILES may pick (the tiles
// that fit in shared memory); a CPU test holds the two lists together.
#define FB_TC_CASES(X) \
    X(bf16, 32, 16, 16) X(bf16, 32, 8, 8) X(bf16, 32, 4, 4) \
    X(bf16, 64, 16, 16) X(bf16, 64, 8, 8) X(bf16, 64, 4, 4) \
    X(bf16, 128, 8, 8) X(bf16, 128, 4, 4) \
    X(bf16, 256, 8, 8) X(bf16, 256, 4, 4) \
    X(f32, 32, 16, 16) X(f32, 32, 8, 8) X(f32, 32, 4, 4) \
    X(f32, 64, 8, 8) X(f32, 64, 4, 4) \
    X(f32, 128, 8, 8) X(f32, 128, 4, 4) \
    X(f32, 256, 4, 4)

extern "C" int fused_block_tc_launch(const void* x, const void* w, const float* ba, void* y,
                                     int n, int h, int w_, int c, int inner, int th, int tw,
                                     int is_bf16, long long smem_bytes, void* stream) {
    int rc = tc_check(x, w, y, c, inner);
    if (rc != 0) return rc;
    BlockArgs a{x, w, ba, y, n, h, w_, c, inner, th, tw};
#define FB_TC_TRY(T_, C_, TH_, TW_) \
    if (tc_try<T_, C_, TH_, TW_, false>(a, is_bf16, smem_bytes, stream, rc)) return rc;
    FB_TC_CASES(FB_TC_TRY)
#undef FB_TC_TRY
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* fused_block_tc_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
