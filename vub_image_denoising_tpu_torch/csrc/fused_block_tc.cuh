// The body of the tensor-core DenoisingBlock kernels for Hopper (sm_90a), in
// bf16 and in f32.  Two libraries instantiate it, each with its own case
// list (FB_TC_CASES) and C entry:
//  - fused_block_tc.cu, kernel 1 on NHWC x and y (PACKED = false);
//  - fused_block_packed_tc.cu, kernel 2 on the 2x2 even-packed layout
//    (PACKED = true).
// It computes what fused_block.cuh computes, with the rounding in the same
// places: f32 accumulation, bias added in f32, one cast to T, PReLU in T,
// o0..o2 held in T, residual added in T (every cast is the identity for f32).
//
// The layout.  Global x and y are touched in two places only, both through
// fb_pixel<PACKED> (fused_block.cuh): the cp.async staging of x into the
// (TH+8) x (TW+8) slab, and the level-3 residual load and y store.  In both
// layouts the c channels of one image pixel are contiguous and start at a
// multiple of c elements, and c*e >= 64 bytes at every width built, so the
// 16-byte cp.async pieces and the paired epilogue stores stay aligned.
// Everything past the slab (the ldmatrix im2col, the weight ring, the
// products, the epilogue) does not see the layout, and neither does any
// output's summation order: unpack2x2 of the packed result equals the NHWC
// result bit for bit.  Tiles are in unpacked (image) coordinates; h and w
// are the image's size, even when packed.
//
// Products, the one thing that differs by element type (struct Tc<T>):
//  - bf16: mma.sync.m16n8k16 bf16 -> f32;
//  - f32: error-compensated TF32 (3xTF32).  Each operand v is split into
//    hi = tf32(v) and lo = tf32(v - hi) (cvt.rna), and a*b is taken as
//    a_lo*b_hi + a_hi*b_lo + a_hi*b_hi: three mma.sync.m16n8k8 TF32 -> f32
//    products, the small terms first, as CUTLASS's 3xTF32 GEMM orders them.
//    The dropped a_lo*b_lo is below 2^-22 of a*b; one TF32 product would
//    lose three decimal digits.  The tensor cores do not round their f32
//    sums to nearest, and their error grows with the number of sums an
//    accumulator takes (with one accumulator per output over all of K, the
//    c = 256 block missed the 1e-4 f32 bar on an H100), so the three
//    products of one k step go into a fresh accumulator that is then added,
//    rounded to nearest, into the level's f32 sum.  A is split once per
//    ldmatrix and reused over the warp's n tiles, B once per k step and
//    reused over its m tiles.
//
// Design.  A thread block (8 warps) owns one (image, TH x TW output tile) and
// the halo pyramid of fused_block.cuh: level L computes a (TH+6-2L) x
// (TW+6-2L) region.  Each level is an implicit GEMM, M = region positions
// (padded to 16), N = inner (c at level 3), K = 9 taps x (c + L*inner):
//  - the whole M x N accumulator of the level lives in registers, split over
//    the warps (tc_pick_wn); the K loop runs over stages of (one 64-byte
//    channel slab of x, or up to 32 channels of one o_j; a group of taps);
//  - A fragments come from ldmatrix over shared memory: a row of A for tap
//    (dy, dx) is the 16-byte channel run of one shifted position of x or of
//    o_j, so the im2col gather is only an address.  For f32 the same
//    ldmatrix.x4.b16 over 32-byte runs gives the m16n8k8 TF32 fragment;
//  - B fragments come from the tap-major (9, K, N) weights of
//    pack_block_params, streamed stage by stage through a double-buffered
//    cp.async ring: ldmatrix.trans for bf16, two 32-bit shared loads per n
//    tile for f32 (ldmatrix.trans moves only 16-bit elements);
//  - x is staged into shared memory with cp.async in slabs of 64 bytes of
//    channels (32 bf16 or 16 f32) over the (TH+8) x (TW+8) level-(-1)
//    region, zero-filled outside the image (double-buffered when c spans
//    more than one slab; at bf16 c = 32 loaded once per block);
//  - the epilogue runs in registers: bias, cast, PReLU, then the zero mask
//    of o0..o2 outside the image, or at level 3 the residual and the store;
//  - rows of x slabs and of o_j are padded by 16 bytes, an odd number of
//    16-byte units, so the 8 rows of an ldmatrix fall on distinct banks;
//    weight rows by 8 elements (16 bytes bf16, 32 bytes f32), which keeps
//    ldmatrix.trans, and the four k rows of an f32 B load, on distinct banks.
// The tile (TH, TW) is picked by ops/fused_block.py (pick_tile_tc), which
// mirrors tc_smem_bytes; every (T, c, TH, TW) it may pick is instantiated in
// each library's FB_TC_CASES.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_block.cuh"

namespace {

typedef __nv_bfloat16 bf16;
typedef float f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kXSlabBytes = 64;              // channel bytes per staged x slab position
constexpr int kXStride = kXSlabBytes + 16;   // bytes per slab position
constexpr int kStageRows = 32;               // K rows per weight stage (at most)

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// Shared-memory layout for element size e (2 or 4 bytes), mirrored by
// ops/fused_block.py tc_smem_bytes:
// [o0 | o1 | o2] [x slab buffers] [2 weight stage buffers]
__host__ __device__ constexpr int tc_positions(int th, int tw, int l) {
    return (th + 6 - 2 * l) * (tw + 6 - 2 * l);
}
__host__ __device__ constexpr int tc_o_stride(int c, int e) { return c / 2 * e + 16; }
// byte offset of o_j (j = 3: the end of o2)
__host__ __device__ constexpr int tc_o_off(int c, int e, int th, int tw, int j) {
    return j == 0 ? 0
                  : tc_o_off(c, e, th, tw, j - 1) + tc_positions(th, tw, j - 1) * tc_o_stride(c, e);
}
__host__ __device__ constexpr int tc_taps_per_stage(int n) { return n <= 64 ? 3 : 1; }
__host__ __device__ constexpr int tc_w_stride(int n, int e) { return (n + 8) * e; }
__host__ __device__ constexpr int tc_w_stage_bytes(int n, int e) {
    return tc_taps_per_stage(n) * kStageRows * tc_w_stride(n, e);
}
__host__ __device__ constexpr int tc_x_bytes(int th, int tw) {
    return (th + 8) * (tw + 8) * kXStride;
}
__host__ __device__ constexpr int tc_x_bufs(int c, int e) { return c * e > kXSlabBytes ? 2 : 1; }
__host__ __device__ constexpr int tc_x_off(int c, int e, int th, int tw) {
    return tc_o_off(c, e, th, tw, 3);
}
__host__ __device__ constexpr int tc_w_bytes(int c, int e) {
    return cmax(tc_w_stage_bytes(c / 2, e), tc_w_stage_bytes(c, e));
}
__host__ __device__ constexpr int tc_w_off(int c, int e, int th, int tw) {
    return tc_x_off(c, e, th, tw) + tc_x_bufs(c, e) * tc_x_bytes(th, tw);
}
__host__ __device__ constexpr int tc_smem_bytes(int c, int e, int th, int tw) {
    return tc_w_off(c, e, th, tw) + 2 * tc_w_bytes(c, e);
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
FB_DEVICE uint32_t lds32(unsigned addr) {
    uint32_t r;
    asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(r) : "r"(addr) : "memory");
    return r;
}
FB_DEVICE void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
FB_DEVICE void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// v = hi + lo (to 2^-22 of v), both TF32 values rounded to nearest
FB_DEVICE void split_tf32(uint32_t v, uint32_t& hi, uint32_t& lo) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(__uint_as_float(v)));
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(__uint_as_float(v) - __uint_as_float(hi)));
}

// What differs by element type: the k depth of one mma, the fragment loads,
// the product, and the paired store and load of the epilogue.
template <typename T> struct Tc;

template <> struct Tc<bf16> {
    static constexpr bool kBf16 = true;
    static constexpr int kK = 16;  // channels per mma k step (32 bytes)
    struct A { uint32_t r[4]; };
    struct B { uint32_t r[2]; };
    // A: rows of 16 positions x 16 channels, this lane's row address at addr
    static FB_DEVICE void load_a(A& a, unsigned addr) { ldsm_x4(a.r, addr); }
    // B of NB n tiles from n tile n8 on, k rows [0, 16) of the stage at rows
    template <int NB>
    static FB_DEVICE void load_b(B (&b)[NB], unsigned rows, int stride, int n8, int lane) {
        const unsigned brow = rows + (lane & 15) * stride + (lane >> 4) * 16 + n8 * 16;
#pragma unroll
        for (int j = 0; j + 1 < NB; j += 2)
            ldsm_x4_trans(b[j].r[0], b[j].r[1], b[j + 1].r[0], b[j + 1].r[1], brow + j * 16);
        if (NB & 1) ldsm_x2_trans(b[NB - 1].r[0], b[NB - 1].r[1], brow + (NB - 1) * 16);
    }
    static FB_DEVICE void mma(float (&d)[4], const A& a, const B& b) {
        mma_bf16(d, a.r, b.r[0], b.r[1]);
    }
    static FB_DEVICE void store2(void* p, float v0, float v1) {
        *static_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
    }
    static FB_DEVICE float2 load2(const void* p) {
        return __bfloat1622float2(*static_cast<const __nv_bfloat162*>(p));
    }
};

template <> struct Tc<f32> {
    static constexpr bool kBf16 = false;
    static constexpr int kK = 8;  // channels per mma k step (32 bytes)
    struct A { uint32_t hi[4], lo[4]; };
    struct B { uint32_t hi[2], lo[2]; };
    // ldmatrix.x4.b16 over 16 positions x 8 f32 channels: matrices (rows
    // 0-7 | 8-15) x (channels 0-3 | 4-7) give a0..a3 = (gid, tig),
    // (gid+8, tig), (gid, tig+4), (gid+8, tig+4), the TF32 A fragment
    static FB_DEVICE void load_a(A& a, unsigned addr) {
        uint32_t r[4];
        ldsm_x4(r, addr);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(r[e], a.hi[e], a.lo[e]);
    }
    // b0 = (k tig, n gid), b1 = (k tig+4, n gid) of each n tile
    template <int NB>
    static FB_DEVICE void load_b(B (&b)[NB], unsigned rows, int stride, int n8, int lane) {
        const unsigned p = rows + (lane & 3) * stride + (n8 * 8 + (lane >> 2)) * 4;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
            split_tf32(lds32(p + j * 32), b[j].hi[0], b[j].lo[0]);
            split_tf32(lds32(p + 4 * stride + j * 32), b[j].hi[1], b[j].lo[1]);
        }
    }
    // d += a*b of one k step: three products into a fresh accumulator, then
    // one f32 add per element, rounded to nearest
    static FB_DEVICE void mma(float (&d)[4], const A& a, const B& b) {
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(p, a.lo, b.hi);
        mma_tf32(p, a.hi, b.lo);
        mma_tf32(p, a.hi, b.hi);
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] += p[e];
    }
    static FB_DEVICE void store2(void* p, float v0, float v1) {
        *static_cast<float2*>(p) = make_float2(v0, v1);
    }
    static FB_DEVICE float2 load2(const void* p) { return *static_cast<const float2*>(p); }
};

// bias in f32 (already added), one cast to T, PReLU in T
template <typename T>
FB_DEVICE float prelu(float v, float alpha) {
    float u = to_f(from_f<T>(v));
    if (!(u > 0.f)) u = to_f(from_f<T>(alpha * u));
    return u;
}

template <typename T, int C, int TH, int TW, int L, bool PACKED>
FB_DEVICE void tc_level(const BlockArgs& a, unsigned sbase, unsigned char* smem,
                        int y0, int x0, int b) {
    typedef Tc<T> Tr;
    constexpr int E = sizeof(T);
    constexpr int XC = kXSlabBytes / E;  // x channels per slab
    constexpr int INNER = C / 2;
    constexpr int RW = TW + 6 - 2 * L;
    constexpr int M = tc_positions(TH, TW, L), MT = cdiv(M, 16);
    constexpr int N = L < 3 ? INNER : C, NT = N / 8, KIN = C + L * INNER;
    constexpr int WN = tc_pick_wn(MT, NT), WM = kWarps / WN;
    constexpr int MTW = cdiv(MT, WM), NTW = NT / WN;
    constexpr int TG = tc_taps_per_stage(N), NG = 9 / TG;
    constexpr int W_STRIDE = tc_w_stride(N, E);
    constexpr int NXC = C / XC;
    constexpr int OC = cmin(INNER, kStageRows), NOC = INNER / OC;
    constexpr int S = (NXC + L * NOC) * NG;
    constexpr int XW = TW + 8, XPOS = (TH + 8) * (TW + 8);
    constexpr int X_BYTES = tc_x_bytes(TH, TW), W_BYTES = tc_w_bytes(C, E);
    constexpr int O_STRIDE = tc_o_stride(C, E);
    constexpr int PR = N * E / 16;  // 16-byte pieces per weight row
    constexpr int X_OFF = tc_x_off(C, E, TH, TW), W_OFF = tc_w_off(C, E, TH, TW);
    constexpr int O_OUT = tc_o_off(C, E, TH, TW, L < 3 ? L : 0);  // where o_L goes

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp % WM, wn = warp / WM;
    const unsigned xs = sbase + X_OFF, ws = sbase + W_OFF;
    const char* xg = static_cast<const char*>(a.x);
    const char* wl = static_cast<const char*>(a.wgt) + fb_weight_offset(C, INNER, L) * E;

    // Stage s = (K chunk ci, tap group g): chunk ci < NXC is x channels
    // [XC ci, XC ci + XC), else OC channels of o_j.
    auto issue = [&](int s) {
        const int ci = s / NG, g = s % NG;
        const int ks = ci < NXC ? XC : OC;
        const int krow0 = ci < NXC ? ci * XC : C + (ci - NXC) * OC;
        const unsigned wdst = ws + (s & 1) * W_BYTES;
        const int pieces = TG * ks * PR;
        for (int p = tid; p < pieces; p += kThreads) {
            const int row = p / PR, piece = p % PR;
            const int t = row / ks, k = row - t * ks;
            const char* src = wl + ((long long)(g * TG + t) * KIN + krow0 + k) * N * E + piece * 16;
            cp_async16(wdst + row * W_STRIDE + piece * 16, src, 16);
        }
        if (g == 0 && ci < NXC && (NXC > 1 || L == 0)) {
            const unsigned xdst = xs + (ci & 1) * X_BYTES;
            for (int p = tid; p < XPOS * (kXSlabBytes / 16); p += kThreads) {
                const int pos = p / (kXSlabBytes / 16), piece = p % (kXSlabBytes / 16);
                const int gy = y0 - 4 + pos / XW, gx = x0 - 4 + pos % XW;
                const bool in = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
                const char* src =
                    in ? xg + (fb_pixel<PACKED>(a, b, gy, gx) + ci * XC) * E + piece * 16 : xg;
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
            sw = XW; shift = L + 1; sstride = kXStride; ks = XC;
        } else {         // o_j: region j, starts 3 - j rows/cols above/left
            const int j = (ci - NXC) / NOC, q = (ci - NXC) % NOC;
            constexpr int O1 = tc_o_off(C, E, TH, TW, 1), O2 = tc_o_off(C, E, TH, TW, 2);
            src = sbase + (j == 0 ? 0 : j == 1 ? O1 : O2) + q * OC * E;
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
            for (int kk = 0; kk < ks; kk += Tr::kK) {
                typename Tr::B bfr[NTW];
                Tr::template load_b<NTW>(bfr, wsrc + (t * ks + kk) * W_STRIDE, W_STRIDE,
                                         wn * NTW, lane);
#pragma unroll
                for (int i = 0; i < MTW; ++i) {
                    if (wm + i * WM >= MT) continue;
                    typename Tr::A afr;
                    Tr::load_a(afr, aaddr[i] + kk * E);
#pragma unroll
                    for (int j = 0; j < NTW; ++j) Tr::mma(acc[i][j], afr, bfr[j]);
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
        const float a0 = to_f(from_f<T>(alpha[n])), a1 = to_f(from_f<T>(alpha[n + 1]));
#pragma unroll
        for (int i = 0; i < MTW; ++i) {
            if (wm + i * WM >= MT) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = (wm + i * WM) * 16 + gid + h * 8;
                if (m >= M) continue;
                const int r = m / RW, sc = m % RW;
                const float v0 = prelu<T>(acc[i][j][2 * h] + b0, a0);
                const float v1 = prelu<T>(acc[i][j][2 * h + 1] + b1, a1);
                const int gy = y0 - 3 + L + r, gx = x0 - 3 + L + sc;
                const bool inside = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
                if (L < 3) {
                    Tr::store2(smem + O_OUT + m * O_STRIDE + n * E, inside ? v0 : 0.f,
                               inside ? v1 : 0.f);
                } else if (inside) {
                    const long long at = (fb_pixel<PACKED>(a, b, gy, gx) + n) * E;
                    const float2 xv = Tr::load2(xg + at);
                    Tr::store2(static_cast<char*>(a.y) + at, v0 + xv.x, v1 + xv.y);
                }
            }
        }
    }
}

template <typename T, int C, int TH, int TW, bool PACKED>
__global__ void __launch_bounds__(kThreads) fused_block_tc_kernel(BlockArgs a) {
    extern __shared__ __align__(128) unsigned char smem[];
    const unsigned sbase = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    const int tiles_x = (a.w + TW - 1) / TW;
    const int y0 = (blockIdx.x / tiles_x) * TH;
    const int x0 = (blockIdx.x % tiles_x) * TW;
    const int b = blockIdx.y;
    tc_level<T, C, TH, TW, 0, PACKED>(a, sbase, smem, y0, x0, b);
    __syncthreads();
    tc_level<T, C, TH, TW, 1, PACKED>(a, sbase, smem, y0, x0, b);
    __syncthreads();
    tc_level<T, C, TH, TW, 2, PACKED>(a, sbase, smem, y0, x0, b);
    __syncthreads();
    tc_level<T, C, TH, TW, 3, PACKED>(a, sbase, smem, y0, x0, b);
}

template <typename T, int C, int TH, int TW, bool PACKED>
int launch(const BlockArgs& a, long long smem_bytes, cudaStream_t stream) {
    constexpr int need = tc_smem_bytes(C, sizeof(T), TH, TW);
    static_assert(need <= 232448, "tile does not fit in shared memory");
    if (smem_bytes != need) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(fused_block_tc_kernel<T, C, TH, TW, PACKED>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, need);
    if (err != cudaSuccess) return (int)err;
    const int tiles = ((a.h + TH - 1) / TH) * ((a.w + TW - 1) / TW);
    dim3 grid(tiles, a.n);
    fused_block_tc_kernel<T, C, TH, TW, PACKED><<<grid, kThreads, need, stream>>>(a);
    return (int)cudaGetLastError();
}

// Checks shared by the C entries: 0, or the error the launch returns.
inline int tc_check(const void* x, const void* w, const void* y, int c, int inner) {
    if (inner * 2 != c) return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
         reinterpret_cast<uintptr_t>(w)) & 15)
        return (int)cudaErrorMisalignedAddress;
    return 0;
}

// Launches instantiation (T, C, TH, TW, PACKED) if it is the one asked for:
// true, with its error code in rc; false when (dtype, c, th, tw) is another.
template <typename T, int C, int TH, int TW, bool PACKED>
bool tc_try(const BlockArgs& a, int is_bf16, long long smem_bytes, void* stream, int& rc) {
    if ((is_bf16 != 0) != Tc<T>::kBf16 || a.c != C || a.th != TH || a.tw != TW) return false;
    rc = launch<T, C, TH, TW, PACKED>(a, smem_bytes, static_cast<cudaStream_t>(stream));
    return true;
}

}  // namespace
