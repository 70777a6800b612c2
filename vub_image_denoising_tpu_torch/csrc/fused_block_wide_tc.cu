// The wide form of both DenoisingBlock kernels, for Hopper (sm_90a) on the
// tensor cores, in bf16 and in f32; plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels `fused_denoising_block` and
// `fused_denoising_block_packed` (vub_image_denoising_tpu/ops/fused_block.py:193
// and :360) at the widths above 256 (c = 512 and 1024: RDUNet-64's and
// RDUNet-128's deepest blocks), where o0..o2 of even a 4x4 tile do not fit
// in shared memory (409,600 bytes in f32 at c = 1024, against 232,448).
//
// Design.  The block runs as four launches of one implicit-GEMM 3x3 conv
// kernel, templated on the element type T, the level L and the layout
// PACKED.  o0..o2 go to a device workspace (n, h, w, 3*inner), NHWC, in T,
// which the wrapper allocates; launch L reads K = 9 x (c + L*inner) from x
// and the workspace's first L*inner channels, and writes o_L into the
// workspace (L < 3) or y = PReLU(conv3) + x (L = 3).  Per thread block:
//  - M: an 8 x 16 tile of output pixels (one m16 tile per tile row);
//  - N: a chunk of 64 output channels; a grid axis runs over the chunks;
//  - K: slabs of 64 bytes of channels (32 bf16 or 16 f32) of x or of the
//    workspace over the (8+2) x (16+2) halo region, with all nine taps of
//    the weights for that slab, double-buffered through cp.async; so the
//    shared memory (2 x (14,400 + 41,472) = 111,744 bytes) does not depend
//    on c, and two thread blocks fit on one SM at every width and dtype;
//  - 8 warps as 4 (tile rows) x 2 (halves of the chunk): each warp owns two
//    m16 tiles by four n8 tiles, in registers over the whole K loop.
// The arithmetic is fused_block_tc.cuh's (struct Tc<T>, ldmatrix, cp.async):
// bf16 mma.sync -> f32; f32 as 3xTF32 with a fresh accumulator per k step
// added rounded to nearest.  Rounding is the fused form's: f32 accumulation,
// bias added in f32, one cast to T, PReLU in T, o0..o2 stored in T (as the
// fused kernels keep them in shared memory), residual added in T.  Samples
// outside the image are the zero fill of the slab loads, as SAME padding.
// With PACKED only the x reads and the y stores take the 2x2 even-packed
// pixel address (fb_pixel); the workspace and every sum are the same, so
// unpack2x2 of the packed result equals the NHWC result bit for bit.
//
// Bound on an H100 SXM: 85.5*c^2*H*W*N FLOP per block, 91.8 GFLOP at
// (1, 512, 64, 64) and at (1, 1024, 32, 32): 0.093 ms at the 989 TFLOP/s
// bf16 peak, 0.557 ms for f32's three TF32 products at 494.7 TFLOP/s.  The
// workspace traffic (o0..o2 written once, read back by the later levels,
// a few MB per block) takes microseconds at 3.35 TB/s: operations bound it.

#include "fused_block_tc.cuh"

namespace {

constexpr int kWideTH = 8, kWideTW = 16;                 // output tile
constexpr int kWideN = 64;                               // output channels per block
constexpr int kWideRW = kWideTW + 2;                     // halo region width
constexpr int kWidePos = (kWideTH + 2) * kWideRW;        // 180 region positions
constexpr int kWideXBytes = kWidePos * kXStride;         // one x slab buffer
// nine taps x (64 bytes / e) k rows x (kWideN + 8) columns of e bytes: the
// same bytes for both element sizes
constexpr int kWideWBytes = 9 * kXSlabBytes * (kWideN + 8);
// mirrored by ops/fused_block.py wide_smem_bytes
constexpr int kWideSmem = 2 * (kWideXBytes + kWideWBytes);
static_assert(2 * kWideSmem <= 233472, "two blocks per SM");

template <typename T, int L, bool PACKED>
__global__ void __launch_bounds__(kThreads, 2) fused_block_wide_kernel(BlockArgs a, void* ws) {
    typedef Tc<T> Tr;
    constexpr int E = sizeof(T);
    constexpr int KC = kXSlabBytes / E;        // channels per K slab
    constexpr int W_STRIDE = (kWideN + 8) * E; // bytes per weight row in shared memory
    constexpr int PR = kWideN * E / 16;        // 16-byte pieces per weight row
    constexpr int WM = 4, WN = 2;              // warps over tile rows x chunk halves
    constexpr int MTW = kWideTH / WM;          // m16 tiles (tile rows) per warp
    constexpr int NTW = kWideN / WN / 8;       // n8 tiles per warp
    static_assert(WM * WN == kWarps && MTW * WM == kWideTH, "warp split");

    extern __shared__ __align__(128) unsigned char smem[];
    const unsigned sbase = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    const unsigned xs = sbase, wsm = sbase + 2 * kWideXBytes;

    const int c = a.c, inner = a.inner;
    const int kin = c + L * inner, nout = L < 3 ? inner : c, wsc = 3 * inner;
    const int tiles_x = (a.w + kWideTW - 1) / kWideTW;
    const int y0 = (blockIdx.x / tiles_x) * kWideTH, x0 = (blockIdx.x % tiles_x) * kWideTW;
    const int n0 = blockIdx.y * kWideN, b = blockIdx.z;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp % WM, wn = warp / WM;
    const char* xg = static_cast<const char*>(a.x);
    const char* wsg = static_cast<const char*>(ws);
    const char* wl = static_cast<const char*>(a.wgt) + fb_weight_offset(c, inner, L) * E;
    const int S = kin / KC;

    // slab s: K rows [s*KC, s*KC + KC) of all nine taps, and those channels
    // of x (rows < c) or of the workspace over the halo region
    auto issue = [&](int s) {
        const int k0 = s * KC;
        const unsigned wdst = wsm + (s & 1) * kWideWBytes;
        for (int p = tid; p < 9 * KC * PR; p += kThreads) {
            const int row = p / PR, piece = p % PR;
            const int t = row / KC, k = row % KC;
            const char* src = wl + ((long long)(t * kin + k0 + k) * nout + n0) * E + piece * 16;
            cp_async16(wdst + row * W_STRIDE + piece * 16, src, 16);
        }
        const unsigned xdst = xs + (s & 1) * kWideXBytes;
        for (int p = tid; p < kWidePos * (kXSlabBytes / 16); p += kThreads) {
            const int pos = p / (kXSlabBytes / 16), piece = p % (kXSlabBytes / 16);
            const int gy = y0 - 1 + pos / kWideRW, gx = x0 - 1 + pos % kWideRW;
            const bool in = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
            const char* src = xg;
            if (in)
                src = (k0 < c ? xg + (fb_pixel<PACKED>(a, b, gy, gx) + k0) * E
                              : wsg + ((((long long)b * a.h + gy) * a.w + gx) * wsc + k0 - c) * E)
                      + piece * 16;
            cp_async16(xdst + pos * kXStride + piece * 16, src, in ? 16 : 0);
        }
    };

    float acc[MTW][NTW][4];
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    issue(0);
    cp_async_commit();
    for (int s = 0; s < S; ++s) {
        if (s + 1 < S) issue(s + 1);
        cp_async_commit();
        cp_async_wait1();
        __syncthreads();
        const unsigned asrc = xs + (s & 1) * kWideXBytes + (lane >> 4) * 16;
        const unsigned wsrc = wsm + (s & 1) * kWideWBytes;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
            const int dy = tap / 3, dx = tap % 3;  // tile pixel (r, q) reads region (r+dy, q+dx)
#pragma unroll
            for (int kk = 0; kk < KC; kk += Tr::kK) {
                typename Tr::B bfr[NTW];
                Tr::template load_b<NTW>(bfr, wsrc + (tap * KC + kk) * W_STRIDE, W_STRIDE,
                                         wn * NTW, lane);
#pragma unroll
                for (int i = 0; i < MTW; ++i) {
                    const int r = wm * MTW + i;
                    typename Tr::A afr;
                    Tr::load_a(afr, asrc + ((r + dy) * kWideRW + (lane & 15) + dx) * kXStride
                                        + kk * E);
#pragma unroll
                    for (int j = 0; j < NTW; ++j) Tr::mma(acc[i][j], afr, bfr[j]);
                }
            }
        }
        __syncthreads();
    }

    // epilogue: accumulator (row gid [+8], cols 2*tig, 2*tig+1) of each tile
    const int gid = lane >> 2, tig = lane & 3;
    const float* bias = a.ba + L * inner;
    const float* alpha = a.ba + 3 * inner + c + L * inner;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
        const int n = n0 + (wn * NTW + j) * 8 + tig * 2;
        const float b0 = bias[n], b1 = bias[n + 1];
        const float a0 = to_f(from_f<T>(alpha[n])), a1 = to_f(from_f<T>(alpha[n + 1]));
#pragma unroll
        for (int i = 0; i < MTW; ++i) {
            const int gy = y0 + wm * MTW + i;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int gx = x0 + gid + h * 8;
                if (gy >= a.h || gx >= a.w) continue;
                const float v0 = prelu<T>(acc[i][j][2 * h] + b0, a0);
                const float v1 = prelu<T>(acc[i][j][2 * h + 1] + b1, a1);
                if (L < 3) {
                    const long long at = (((long long)b * a.h + gy) * a.w + gx) * wsc + L * inner + n;
                    Tr::store2(static_cast<char*>(ws) + at * E, v0, v1);
                } else {
                    const long long at = (fb_pixel<PACKED>(a, b, gy, gx) + n) * E;
                    const float2 xv = Tr::load2(xg + at);
                    Tr::store2(static_cast<char*>(a.y) + at, v0 + xv.x, v1 + xv.y);
                }
            }
        }
    }
}

template <typename T, int L, bool PACKED>
int wide_level(const BlockArgs& a, void* ws, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(fused_block_wide_kernel<T, L, PACKED>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmem);
    if (err != cudaSuccess) return (int)err;
    const int nout = L < 3 ? a.inner : a.c;
    dim3 grid(cdiv(a.h, kWideTH) * cdiv(a.w, kWideTW), nout / kWideN, a.n);
    fused_block_wide_kernel<T, L, PACKED><<<grid, kThreads, kWideSmem, stream>>>(a, ws);
    return (int)cudaGetLastError();
}

template <typename T, bool PACKED>
int wide_block(const BlockArgs& a, void* ws, cudaStream_t stream) {
    int rc = wide_level<T, 0, PACKED>(a, ws, stream);
    if (rc == 0) rc = wide_level<T, 1, PACKED>(a, ws, stream);
    if (rc == 0) rc = wide_level<T, 2, PACKED>(a, ws, stream);
    if (rc == 0) rc = wide_level<T, 3, PACKED>(a, ws, stream);
    return rc;
}

}  // namespace

// x, y: (n, h, w, c) NHWC, or with packed != 0 the even-packed (n, h/2, w/2,
// 4c) (h and w the image's size, both even); ws: (n, h, w, 3*inner) NHWC;
// all in the element type (bf16 when is_bf16, else f32).  c must be a
// multiple of 2*64 (inner a multiple of the 64-channel chunk).
extern "C" int fused_block_wide_tc_launch(const void* x, const void* w, const float* ba, void* y,
                                          void* ws, int n, int h, int w_, int c, int inner,
                                          int is_bf16, int packed, long long smem_bytes,
                                          void* stream) {
    if (inner * 2 != c || c % (2 * kWideN) != 0 || smem_bytes != kWideSmem || n > 65535)
        return (int)cudaErrorInvalidValue;
    if (packed && ((h & 1) || (w_ & 1))) return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
         reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(ws)) & 15)
        return (int)cudaErrorMisalignedAddress;
    BlockArgs a{x, w, ba, y, n, h, w_, c, inner, kWideTH, kWideTW};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return packed ? wide_block<bf16, true>(a, ws, s) : wide_block<bf16, false>(a, ws, s);
    return packed ? wide_block<f32, true>(a, ws, s) : wide_block<f32, false>(a, ws, s);
}

extern "C" const char* fused_block_wide_tc_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
