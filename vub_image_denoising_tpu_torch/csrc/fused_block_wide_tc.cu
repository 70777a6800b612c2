// The wide form of both DenoisingBlock kernels, for Hopper (sm_90a) on the
// tensor cores, in bf16 and in f32; plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels `fused_denoising_block` and
// `fused_denoising_block_packed` (vub_image_denoising_tpu/ops/fused_block.py:193
// and :360) at every width above 256 (c = 512 and 1024: RDUNet-64's and
// RDUNet-128's deepest blocks; 304, 384, 608, 1216, ...: the other bases'),
// where o0..o2 of even a 4x4 tile do not fit in shared memory (409,600 bytes
// in f32 at c = 1024, against 232,448).
//
// Design.  The block runs as four launches of one implicit-GEMM 3x3 conv
// kernel, templated on the element type T, the level L, the layout PACKED
// and the 16-byte alignment VEC.  o0..o2 go to a device workspace (n, h, w, 3*inner), NHWC, in T,
// which the wrapper allocates; launch L reads K = 9 x (c + L*inner) from x
// and the workspace's first L*inner channels, and writes o_L into the
// workspace (L < 3) or y = PReLU(conv3) + x (L = 3).  Per thread block:
//  - M: an 8 x 16 tile of output pixels (one m16 tile per tile row);
//  - N: a chunk of 64 output channels; a grid axis runs over the chunks,
//    and the last one may be partial (its weight columns past the level's
//    outputs load as zero, their stores are masked);
//  - K: slabs of 64 bytes of channels (32 bf16 or 16 f32) of the level's
//    input [x, o0, .., o_{L-1}] over the (8+2) x (16+2) halo region, with
//    all nine taps of the weights for that slab, double-buffered through
//    cp.async; a slab may span the end of x and the start of the workspace,
//    and the last may be partial (rows past K load as zero on both sides,
//    cp.async's zero fill with a source size of 0); so the
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
// VEC: c and inner are multiples of 16 bytes of channels, so every 16-byte
// piece of a slab, a weight row or a channel run lies in one tensor and is
// aligned (304, 320, 352, 608, 1216, ...); otherwise (c = 258 or 260 of an
// RDUNet of base 129 or 65) the slabs are gathered one element at a time
// with plain loads and the epilogue stores single elements.  The products,
// the shared memory and every sum are the same in both.
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

template <typename T, int L, bool PACKED, bool VEC>
__global__ void __launch_bounds__(kThreads, 2) fused_block_wide_kernel(BlockArgs a, void* ws) {
    typedef Tc<T> Tr;
    constexpr int E = sizeof(T);
    constexpr int KC = kXSlabBytes / E;        // channels per K slab
    constexpr int PE = 16 / E;                 // elements per 16-byte piece
    constexpr int W_STRIDE = (kWideN + 8) * E; // bytes per weight row in shared memory
    constexpr int PR = kWideN / PE;            // 16-byte pieces per weight row
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
    const int S = cdiv(kin, KC);

    // element offset (in bytes) of input channel k < kin at image pixel (gy, gx):
    // x's channel k, or the workspace's channel k - c (o0..o2 in order)
    auto in_at = [&](int gy, int gx, int k) -> const char* {
        return k < c ? xg + (fb_pixel<PACKED>(a, b, gy, gx) + k) * E
                     : wsg + ((((long long)b * a.h + gy) * a.w + gx) * wsc + k - c) * E;
    };

    // slab s: K rows [s*KC, s*KC + KC) of all nine taps, and those channels
    // of the level's input over the halo region; rows at or past kin, and
    // weight columns at or past nout, are zero
    auto issue = [&](int s) {
        const int k0 = s * KC;
        const unsigned wdst = wsm + (s & 1) * kWideWBytes;
        const unsigned xdst = xs + (s & 1) * kWideXBytes;
        if constexpr (VEC) {
            for (int p = tid; p < 9 * KC * PR; p += kThreads) {
                const int row = p / PR, piece = p % PR;
                const int t = row / KC, k = k0 + row % KC, n = n0 + piece * PE;
                const bool ok = k < kin && n < nout;
                const char* src = ok ? wl + ((long long)(t * kin + k) * nout + n) * E : wl;
                cp_async16(wdst + row * W_STRIDE + piece * 16, src, ok ? 16 : 0);
            }
            for (int p = tid; p < kWidePos * (KC / PE); p += kThreads) {
                const int pos = p / (KC / PE), piece = p % (KC / PE);
                const int gy = y0 - 1 + pos / kWideRW, gx = x0 - 1 + pos % kWideRW;
                const int k = k0 + piece * PE;
                const bool ok = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w && k < kin;
                cp_async16(xdst + pos * kXStride + piece * 16, ok ? in_at(gy, gx, k) : xg,
                           ok ? 16 : 0);
            }
        } else {
            unsigned char* wd = smem + (wdst - sbase);
            for (int p = tid; p < 9 * KC * kWideN; p += kThreads) {
                const int row = p / kWideN, col = p % kWideN;
                const int t = row / KC, k = k0 + row % KC, n = n0 + col;
                T v = from_f<T>(0.f);
                if (k < kin && n < nout)
                    v = *reinterpret_cast<const T*>(wl + ((long long)(t * kin + k) * nout + n) * E);
                *reinterpret_cast<T*>(wd + row * W_STRIDE + col * E) = v;
            }
            unsigned char* xd = smem + (xdst - sbase);
            for (int p = tid; p < kWidePos * KC; p += kThreads) {
                const int pos = p / KC, e = p % KC;
                const int gy = y0 - 1 + pos / kWideRW, gx = x0 - 1 + pos % kWideRW;
                const int k = k0 + e;
                T v = from_f<T>(0.f);
                if (gy >= 0 && gy < a.h && gx >= 0 && gx < a.w && k < kin)
                    v = *reinterpret_cast<const T*>(in_at(gy, gx, k));
                *reinterpret_cast<T*>(xd + pos * kXStride + e * E) = v;
            }
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

    // epilogue: accumulator (row gid [+8], cols 2*tig, 2*tig+1) of each tile;
    // outputs at or past nout (a partial last chunk) are not stored
    const int gid = lane >> 2, tig = lane & 3;
    const float* bias = a.ba + L * inner;
    const float* alpha = a.ba + 3 * inner + c + L * inner;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
        const int n = n0 + (wn * NTW + j) * 8 + tig * 2;
        const int m = n + 1 < nout ? 2 : nout - n;  // outputs of the pair to store
        if (m <= 0) continue;
        const float b0 = bias[n], b1 = m > 1 ? bias[n + 1] : 0.f;
        const float a0 = to_f(from_f<T>(alpha[n])), a1 = m > 1 ? to_f(from_f<T>(alpha[n + 1])) : 0.f;
#pragma unroll
        for (int i = 0; i < MTW; ++i) {
            const int gy = y0 + wm * MTW + i;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int gx = x0 + gid + h * 8;
                if (gy >= a.h || gx >= a.w) continue;
                float v[2] = {prelu<T>(acc[i][j][2 * h] + b0, a0),
                              prelu<T>(acc[i][j][2 * h + 1] + b1, a1)};
                char* out;
                if (L < 3) {
                    out = static_cast<char*>(ws)
                          + ((((long long)b * a.h + gy) * a.w + gx) * wsc + L * inner + n) * E;
                } else {
                    const long long at = (fb_pixel<PACKED>(a, b, gy, gx) + n) * E;
                    out = static_cast<char*>(a.y) + at;
                    if (VEC) {
                        const float2 xv = Tr::load2(xg + at);
                        v[0] += xv.x;
                        v[1] += xv.y;
                    } else {
                        for (int e = 0; e < m; ++e)
                            v[e] += to_f(*reinterpret_cast<const T*>(xg + at + e * E));
                    }
                }
                if (VEC) {
                    Tr::store2(out, v[0], v[1]);
                } else {
                    for (int e = 0; e < m; ++e) *reinterpret_cast<T*>(out + e * E) = from_f<T>(v[e]);
                }
            }
        }
    }
}

template <typename T, int L, bool PACKED, bool VEC>
int wide_level(const BlockArgs& a, void* ws, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(fused_block_wide_kernel<T, L, PACKED, VEC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmem);
    if (err != cudaSuccess) return (int)err;
    const int nout = L < 3 ? a.inner : a.c;
    dim3 grid(cdiv(a.h, kWideTH) * cdiv(a.w, kWideTW), cdiv(nout, kWideN), a.n);
    fused_block_wide_kernel<T, L, PACKED, VEC><<<grid, kThreads, kWideSmem, stream>>>(a, ws);
    return (int)cudaGetLastError();
}

template <typename T, bool PACKED, bool VEC>
int wide_block(const BlockArgs& a, void* ws, cudaStream_t stream) {
    int rc = wide_level<T, 0, PACKED, VEC>(a, ws, stream);
    if (rc == 0) rc = wide_level<T, 1, PACKED, VEC>(a, ws, stream);
    if (rc == 0) rc = wide_level<T, 2, PACKED, VEC>(a, ws, stream);
    if (rc == 0) rc = wide_level<T, 3, PACKED, VEC>(a, ws, stream);
    return rc;
}

template <typename T, bool VEC>
int wide_dispatch(const BlockArgs& a, void* ws, bool packed, cudaStream_t stream) {
    return packed ? wide_block<T, true, VEC>(a, ws, stream)
                  : wide_block<T, false, VEC>(a, ws, stream);
}

}  // namespace

// x, y: (n, h, w, c) NHWC, or with packed != 0 the even-packed (n, h/2, w/2,
// 4c) (h and w the image's size, both even); ws: (n, h, w, 3*inner) NHWC;
// all in the element type (bf16 when is_bf16, else f32).  Any c >= 1 with
// inner = c / 2 (rounded down, as DenoisingBlock's); the 16-byte path when
// c and inner are multiples of 16 bytes and the pointers 16-byte aligned.
extern "C" int fused_block_wide_tc_launch(const void* x, const void* w, const float* ba, void* y,
                                          void* ws, int n, int h, int w_, int c, int inner,
                                          int is_bf16, int packed, long long smem_bytes,
                                          void* stream) {
    if (c < 2 || inner != c / 2 || smem_bytes != kWideSmem || n > 65535)
        return (int)cudaErrorInvalidValue;
    if (packed && ((h & 1) || (w_ & 1))) return (int)cudaErrorInvalidValue;
    const int e = is_bf16 ? 2 : 4;
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                           reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(ws);
    if (ptrs & (e - 1)) return (int)cudaErrorMisalignedAddress;
    const bool vec = (c * e) % 16 == 0 && (inner * e) % 16 == 0 && (ptrs & 15) == 0;
    BlockArgs a{x, w, ba, y, n, h, w_, c, inner, kWideTH, kWideTW};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return vec ? wide_dispatch<bf16, true>(a, ws, packed, s)
                   : wide_dispatch<bf16, false>(a, ws, packed, s);
    return vec ? wide_dispatch<f32, true>(a, ws, packed, s)
               : wide_dispatch<f32, false>(a, ws, packed, s);
}

extern "C" const char* fused_block_wide_tc_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
