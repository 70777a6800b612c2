// Fused DenoisingBlock on the 2x2 even-packed layout, for Hopper (sm_90a) on
// the tensor cores, in bf16 and in f32; plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `fused_denoising_block_packed`
// (vub_image_denoising_tpu/ops/fused_block.py:360) for bf16 and f32 inputs
// with c in ops/fused_block.py TC_WIDTHS (16, 32, 64, 128, 256, and 152 in
// bf16); every other width takes the wide form (fused_block_wide_tc.cu).  It
// keeps the TPU kernel's contract: x and y are even-packed (n, h/2, w/2, 4c),
// packed channel (a*2+b)*c + k holding image pixel (2I+a, 2J+b), and
// unpack2x2(y) equals kernel 1 on unpack2x2(x).
//
// Design: the packed layout was a TPU device (it fills 128 lanes and meets
// the DMA lane rule); Hopper needs neither, and one image pixel's c
// channels are contiguous in it as in NHWC.  So this is kernel 1's
// tensor-core body (fused_block_tc.cuh) with PACKED = true: x is staged and
// y stored through the packed pixel address, and the nine 3x3 taps run as
// in kernel 1 (1.0x the useful FLOPs, against 16/9 for the TPU's 2x2 packed
// taps), in the same summation order, so unpack2x2(y) equals kernel 1's
// output bit for bit.  The tap-major (9, K, N) weights are gathered from the
// packed ones by the wrapper (ops/fused_block.py kernel_weights_from_packed).
// With h and w even the packed border is exactly the unpacked one.
//
// Bound on an H100 SXM: the FLOPs and bytes of kernel 1 (fused_block_tc.cu),
// so operations bound it: for the 12 RDUNet-32 blocks at c <= 128, batch 8,
// 256^2, 0.557 ms in bf16 and 3.340 ms in f32 as 3xTF32.

#include "fused_block_tc.cuh"

// Every (T, c, th, tw) that ops/fused_block.py TC_TILES may pick, as in
// fused_block_tc.cu; a CPU test holds the two lists together.
#define FB_TC_CASES(X) \
    X(bf16, 16, 16, 16) X(bf16, 16, 8, 8) X(bf16, 16, 4, 4) \
    X(bf16, 32, 16, 16) X(bf16, 32, 8, 8) X(bf16, 32, 4, 4) \
    X(bf16, 64, 16, 16) X(bf16, 64, 8, 8) X(bf16, 64, 4, 4) \
    X(bf16, 128, 8, 8) X(bf16, 128, 4, 4) \
    X(bf16, 152, 8, 8) X(bf16, 152, 4, 4) \
    X(bf16, 256, 8, 8) X(bf16, 256, 4, 4) \
    X(f32, 16, 16, 16) X(f32, 16, 8, 8) X(f32, 16, 4, 4) \
    X(f32, 32, 16, 16) X(f32, 32, 8, 8) X(f32, 32, 4, 4) \
    X(f32, 64, 8, 8) X(f32, 64, 4, 4) \
    X(f32, 128, 8, 8) X(f32, 128, 4, 4) \
    X(f32, 256, 4, 4)

// h, w: the unpacked image size (both even).
extern "C" int fused_block_packed_tc_launch(const void* x, const void* w, const float* ba,
                                            void* y, int n, int h, int w_, int c, int inner,
                                            int th, int tw, int is_bf16, long long smem_bytes,
                                            void* stream) {
    if ((h & 1) || (w_ & 1)) return (int)cudaErrorInvalidValue;
    int rc = tc_check(x, w, y, c, inner);
    if (rc != 0) return rc;
    BlockArgs a{x, w, ba, y, n, h, w_, c, inner, th, tw};
#define FB_TC_TRY(T_, C_, TH_, TW_) \
    if (tc_try<T_, C_, TH_, TW_, true>(a, is_bf16, smem_bytes, stream, rc)) return rc;
    FB_TC_CASES(FB_TC_TRY)
#undef FB_TC_TRY
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* fused_block_packed_tc_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
