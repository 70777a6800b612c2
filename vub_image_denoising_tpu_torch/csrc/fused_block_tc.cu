// Fused DenoisingBlock for Hopper (sm_90a) on the tensor cores, bf16 only;
// plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `fused_denoising_block`
// (vub_image_denoising_tpu/ops/fused_block.py:193) for bf16 inputs with
// c in {32, 64, 128, 256}; f32 and other widths stay on the CUDA-core kernel
// (fused_block.cu).  It computes what fused_block.cu computes, with the
// rounding in the same places: f32 accumulation, bias added in f32, one cast
// to bf16, PReLU in bf16, o0..o2 held in bf16, residual added in bf16.
//
// Bound on an H100 SXM: 85.5*c^2*H*W*N FLOP per launch (45.9 GFLOP for every
// RDUNet-32 block at batch 8, 256^2), 46 us at the 989 TFLOP/s bf16 dense
// peak, against ~20 us for the bytes of x and y: operations bound it, so the
// products go to the tensor cores.
//
// Design.  A thread block (8 warps) owns one (image, TH x TW output tile) and
// the halo pyramid of fused_block.cuh: level L computes a (TH+6-2L) x
// (TW+6-2L) region.  Each level is an implicit GEMM, M = region positions
// (padded to 16), N = inner (c at level 3), K = 9 taps x (c + L*inner):
//  - the whole M x N accumulator of the level lives in registers, split over
//    the warps (tc_pick_wn); the K loop runs over stages of (32 input
//    channels of one source, a group of taps);
//  - A fragments come from ldmatrix over shared memory: a row of A for tap
//    (dy, dx) is the 16-byte channel run of one shifted position of x or of
//    o_j, so the im2col gather is only an address;
//  - B fragments come from ldmatrix.trans over the tap-major (9, K, N)
//    weights of pack_block_params, streamed stage by stage through a
//    double-buffered cp.async ring;
//  - x is staged into shared memory with cp.async in slabs of 32 channels
//    over the (TH+8) x (TW+8) level-(-1) region, zero-filled outside the
//    image (double-buffered when c > 32; at c = 32 loaded once per block);
//  - products are mma.sync.m16n8k16 bf16 -> f32;
//  - the epilogue runs in registers: bias, cast, PReLU, then the zero mask
//    of o0..o2 outside the image, or at level 3 the residual and the store;
//  - every shared row (a position's channels, a weight row) is padded by
//    16 bytes, an odd number of 16-byte units, so the 8 rows of an ldmatrix
//    fall on distinct banks.
// The tile (TH, TW) is picked by ops/fused_block.py (pick_tile_tc), which
// mirrors tc_smem_bytes; every (c, TH, TW) it may pick is instantiated in
// FB_TC_CASES below.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_block.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kXChunk = 32;                  // x channels per staged slab
constexpr int kXStride = kXChunk * 2 + 16;   // bytes per slab position
constexpr int kStageRows = 32;               // K rows per weight stage (at most)

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// Shared-memory layout, mirrored by ops/fused_block.py tc_smem_bytes:
// [o0 | o1 | o2] [x slab buffers] [2 weight stage buffers]
__host__ __device__ constexpr int tc_positions(int th, int tw, int l) {
    return (th + 6 - 2 * l) * (tw + 6 - 2 * l);
}
__host__ __device__ constexpr int tc_o_stride(int c) { return c + 16; }  // inner bf16 + pad
// byte offset of o_j (j = 3: the end of o2)
__host__ __device__ constexpr int tc_o_off(int c, int th, int tw, int j) {
    return j == 0 ? 0 : tc_o_off(c, th, tw, j - 1) + tc_positions(th, tw, j - 1) * tc_o_stride(c);
}
__host__ __device__ constexpr int tc_taps_per_stage(int n) { return n <= 64 ? 3 : 1; }
__host__ __device__ constexpr int tc_w_stage_bytes(int n) {
    return tc_taps_per_stage(n) * kStageRows * (n * 2 + 16);
}
__host__ __device__ constexpr int tc_x_bytes(int th, int tw) {
    return (th + 8) * (tw + 8) * kXStride;
}
__host__ __device__ constexpr int tc_x_off(int c, int th, int tw) { return tc_o_off(c, th, tw, 3); }
__host__ __device__ constexpr int tc_w_bytes(int c) {
    return cmax(tc_w_stage_bytes(c / 2), tc_w_stage_bytes(c));
}
__host__ __device__ constexpr int tc_w_off(int c, int th, int tw) {
    return tc_x_off(c, th, tw) + (c > kXChunk ? 2 : 1) * tc_x_bytes(th, tw);
}
__host__ __device__ constexpr int tc_smem_bytes(int c, int th, int tw) {
    return tc_w_off(c, th, tw) + 2 * tc_w_bytes(c);
}

// Warps split a level's (MT m16 tiles) x (NT n8 tiles) as WM x WN; the
// split minimises the busiest warp's mma count plus its fragment loads.
__host__ __device__ constexpr int tc_warp_cost(int mt, int nt, int wn) {
    return cdiv(mt, kWarps / wn) * (nt / wn) + cdiv(mt, kWarps / wn) + cdiv(nt / wn, 2);
}
__host__ __device__ constexpr int tc_pick_wn(int mt, int nt) {
    int best = 1;
    for (int wn = 2; wn <= kWarps; wn *= 2)
        if (nt % wn == 0 && tc_warp_cost(mt, nt, wn) < tc_warp_cost(mt, nt, best)) best = wn;
    return best;
}

FB_DEVICE void cp_async16(unsigned dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
FB_DEVICE void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
FB_DEVICE void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

FB_DEVICE void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
FB_DEVICE void ldsm_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                             unsigned addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr) : "memory");
}
FB_DEVICE void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, unsigned addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r0), "=r"(r1) : "r"(addr) : "memory");
}
FB_DEVICE void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bias in f32 (already added), one cast to bf16, PReLU in bf16
FB_DEVICE float prelu_bf16(float v, float alpha) {
    float u = __bfloat162float(__float2bfloat16_rn(v));
    if (!(u > 0.f)) u = __bfloat162float(__float2bfloat16_rn(alpha * u));
    return u;
}

template <int C, int TH, int TW, int L>
FB_DEVICE void tc_level(const BlockArgs& a, unsigned sbase, unsigned char* smem,
                        int y0, int x0, int b) {
    constexpr int INNER = C / 2;
    constexpr int RW = TW + 6 - 2 * L;
    constexpr int M = tc_positions(TH, TW, L), MT = cdiv(M, 16);
    constexpr int N = L < 3 ? INNER : C, NT = N / 8, KIN = C + L * INNER;
    constexpr int WN = tc_pick_wn(MT, NT), WM = kWarps / WN;
    constexpr int MTW = cdiv(MT, WM), NTW = NT / WN;
    constexpr int TG = tc_taps_per_stage(N), NG = 9 / TG;
    constexpr int W_STRIDE = N * 2 + 16;
    constexpr int NXC = C / kXChunk;
    constexpr int OC = cmin(INNER, kStageRows), NOC = INNER / OC;
    constexpr int S = (NXC + L * NOC) * NG;
    constexpr int XW = TW + 8, XPOS = (TH + 8) * (TW + 8);
    constexpr int X_BYTES = tc_x_bytes(TH, TW), W_BYTES = tc_w_bytes(C);
    constexpr int O_STRIDE = tc_o_stride(C);
    constexpr int PR = N / 8;  // 16-byte pieces per weight row
    constexpr int X_OFF = tc_x_off(C, TH, TW), W_OFF = tc_w_off(C, TH, TW);
    constexpr int O_OUT = tc_o_off(C, TH, TW, L < 3 ? L : 0);  // where o_L goes

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp % WM, wn = warp / WM;
    const unsigned xs = sbase + X_OFF, ws = sbase + W_OFF;
    const bf16* xg = static_cast<const bf16*>(a.x);
    const bf16* wl = static_cast<const bf16*>(a.wgt) + fb_weight_offset(C, INNER, L);

    // Stage s = (K chunk ci, tap group g): chunk ci < NXC is x channels
    // [32 ci, 32 ci + 32), else OC channels of o_j.
    auto issue = [&](int s) {
        const int ci = s / NG, g = s % NG;
        const int ks = ci < NXC ? kXChunk : OC;
        const int krow0 = ci < NXC ? ci * kXChunk : C + (ci - NXC) * OC;
        const unsigned wdst = ws + (s & 1) * W_BYTES;
        const int pieces = TG * ks * PR;
        for (int p = tid; p < pieces; p += kThreads) {
            const int row = p / PR, piece = p % PR;
            const int t = row / ks, k = row - t * ks;
            const bf16* src = wl + ((long long)(g * TG + t) * KIN + krow0 + k) * N + piece * 8;
            cp_async16(wdst + row * W_STRIDE + piece * 16, src, 16);
        }
        if (g == 0 && ci < NXC && (NXC > 1 || L == 0)) {
            const unsigned xdst = xs + (ci & 1) * X_BYTES;
            for (int p = tid; p < XPOS * (kXChunk / 8); p += kThreads) {
                const int pos = p / (kXChunk / 8), piece = p % (kXChunk / 8);
                const int gy = y0 - 4 + pos / XW, gx = x0 - 4 + pos % XW;
                const bool in = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
                const bf16* src = in ? xg + fb_pixel<false>(a, b, gy, gx) + ci * kXChunk + piece * 8
                                     : xg;
                cp_async16(xdst + pos * kXStride + piece * 16, src, in ? 16 : 0);
            }
        }
    };

    // this lane's A row (ldmatrix address row) in each of its m tiles
    int rr[MTW], ss[MTW];
#pragma unroll
    for (int i = 0; i < MTW; ++i) {
        const int m = cmin((wm + i * WM) * 16 + (lane & 15), M - 1);
        rr[i] = m / RW;
        ss[i] = m % RW;
    }
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
        const int ci = s / NG, g = s % NG;
        unsigned src;
        int sw, shift, sstride, ks;
        if (ci < NXC) {  // x slab: region -1, starts 4 rows/cols above/left
            src = xs + (ci & 1) * X_BYTES;
            sw = XW; shift = L + 1; sstride = kXStride; ks = kXChunk;
        } else {         // o_j: region j, starts 3 - j rows/cols above/left
            const int j = (ci - NXC) / NOC, q = (ci - NXC) % NOC;
            constexpr int O1 = tc_o_off(C, TH, TW, 1), O2 = tc_o_off(C, TH, TW, 2);
            src = sbase + (j == 0 ? 0 : j == 1 ? O1 : O2) + q * OC * 2;
            sw = TW + 6 - 2 * j; shift = L - j; sstride = O_STRIDE; ks = OC;
        }
        const unsigned wsrc = ws + (s & 1) * W_BYTES;
#pragma unroll
        for (int t = 0; t < TG; ++t) {
            const int tap = g * TG + t, dy = tap / 3 - 1, dx = tap % 3 - 1;
            unsigned aaddr[MTW];
#pragma unroll
            for (int i = 0; i < MTW; ++i)
                aaddr[i] = src + ((rr[i] + shift + dy) * sw + ss[i] + shift + dx) * sstride
                           + (lane >> 4) * 16;
            for (int kk = 0; kk < ks; kk += 16) {
                uint32_t bfr[NTW][2];
                const unsigned brow =
                    wsrc + (t * ks + kk + (lane & 15)) * W_STRIDE + (lane >> 4) * 16;
#pragma unroll
                for (int j = 0; j + 1 < NTW; j += 2)
                    ldsm_x4_trans(bfr[j][0], bfr[j][1], bfr[j + 1][0], bfr[j + 1][1],
                                  brow + (wn * NTW + j) * 16);
                if (NTW & 1)
                    ldsm_x2_trans(bfr[NTW - 1][0], bfr[NTW - 1][1],
                                  brow + (wn * NTW + NTW - 1) * 16);
#pragma unroll
                for (int i = 0; i < MTW; ++i) {
                    if (wm + i * WM >= MT) continue;
                    uint32_t afr[4];
                    ldsm_x4(afr, aaddr[i] + kk * 2);
#pragma unroll
                    for (int j = 0; j < NTW; ++j) mma_bf16(acc[i][j], afr, bfr[j][0], bfr[j][1]);
                }
            }
        }
        __syncthreads();
    }

    // epilogue: accumulator (row gid [+8], cols 2*tig, 2*tig+1) of each tile
    const int gid = lane >> 2, tig = lane & 3;
    const float* bias = a.ba + L * INNER;
    const float* alpha = a.ba + 3 * INNER + C + L * INNER;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
        const int n = (wn * NTW + j) * 8 + tig * 2;
        const float b0 = bias[n], b1 = bias[n + 1];
        const float a0 = __bfloat162float(__float2bfloat16_rn(alpha[n]));
        const float a1 = __bfloat162float(__float2bfloat16_rn(alpha[n + 1]));
#pragma unroll
        for (int i = 0; i < MTW; ++i) {
            if (wm + i * WM >= MT) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = (wm + i * WM) * 16 + gid + h * 8;
                if (m >= M) continue;
                const int r = m / RW, sc = m % RW;
                const float v0 = prelu_bf16(acc[i][j][2 * h] + b0, a0);
                const float v1 = prelu_bf16(acc[i][j][2 * h + 1] + b1, a1);
                const int gy = y0 - 3 + L + r, gx = x0 - 3 + L + sc;
                const bool inside = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
                if (L < 3) {
                    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
                        smem + O_OUT + m * O_STRIDE + n * 2);
                    *o = inside ? __floats2bfloat162_rn(v0, v1) : __floats2bfloat162_rn(0.f, 0.f);
                } else if (inside) {
                    const long long at = fb_pixel<false>(a, b, gy, gx) + n;
                    const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(xg + at);
                    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.y) + at) =
                        __floats2bfloat162_rn(v0 + __bfloat162float(xv.x),
                                              v1 + __bfloat162float(xv.y));
                }
            }
        }
    }
}

template <int C, int TH, int TW>
__global__ void __launch_bounds__(kThreads) fused_block_tc_kernel(BlockArgs a) {
    extern __shared__ __align__(128) unsigned char smem[];
    const unsigned sbase = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    const int tiles_x = (a.w + TW - 1) / TW;
    const int y0 = (blockIdx.x / tiles_x) * TH;
    const int x0 = (blockIdx.x % tiles_x) * TW;
    const int b = blockIdx.y;
    tc_level<C, TH, TW, 0>(a, sbase, smem, y0, x0, b);
    __syncthreads();
    tc_level<C, TH, TW, 1>(a, sbase, smem, y0, x0, b);
    __syncthreads();
    tc_level<C, TH, TW, 2>(a, sbase, smem, y0, x0, b);
    __syncthreads();
    tc_level<C, TH, TW, 3>(a, sbase, smem, y0, x0, b);
}

template <int C, int TH, int TW>
int launch(const BlockArgs& a, long long smem_bytes, cudaStream_t stream) {
    constexpr int need = tc_smem_bytes(C, TH, TW);
    static_assert(need <= 232448, "tile does not fit in shared memory");
    if (smem_bytes != need) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        fused_block_tc_kernel<C, TH, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize, need);
    if (err != cudaSuccess) return (int)err;
    const int tiles = ((a.h + TH - 1) / TH) * ((a.w + TW - 1) / TW);
    dim3 grid(tiles, a.n);
    fused_block_tc_kernel<C, TH, TW><<<grid, kThreads, need, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// Every (c, th, tw) that ops/fused_block.py TC_TILES may pick (the tiles
// that fit in shared memory); a CPU test holds the two lists together.
#define FB_TC_CASES(X) \
    X(32, 16, 16) X(32, 8, 8) X(32, 4, 4) \
    X(64, 16, 16) X(64, 8, 8) X(64, 4, 4) \
    X(128, 8, 8) X(128, 4, 4) \
    X(256, 8, 8) X(256, 4, 4)

extern "C" int fused_block_tc_launch(const void* x, const void* w, const float* ba, void* y,
                                     int n, int h, int w_, int c, int inner, int th, int tw,
                                     int is_bf16, long long smem_bytes, void* stream) {
    if (!is_bf16 || inner * 2 != c) return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
         reinterpret_cast<uintptr_t>(w)) & 15)
        return (int)cudaErrorMisalignedAddress;
    BlockArgs a{x, w, ba, y, n, h, w_, c, inner, th, tw};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FB_TC_DISPATCH(C_, TH_, TW_) \
    if (c == C_ && th == TH_ && tw == TW_) return launch<C_, TH_, TW_>(a, smem_bytes, s);
    FB_TC_CASES(FB_TC_DISPATCH)
#undef FB_TC_DISPATCH
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* fused_block_tc_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
