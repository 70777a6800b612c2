// One DenoisingBlock, one output tile: the arithmetic of the fused kernels
// (fused_block.cu on NHWC, fused_block_packed.cu on the 2x2 even-packed layout).
//
// A thread block owns one (image b, th x tw output tile).  The block runs the
// four convs as four levels over a shrinking halo pyramid:
//
//   level L   region rows/cols            input                 output
//   0         (th+6) x (tw+6), offset 3   x                     o0 -> shared
//   1         (th+4) x (tw+4), offset 2   [x, o0]               o1 -> shared
//   2         (th+2) x (tw+2), offset 1   [x, o0, o1]           o2 -> shared
//   3          th    x  tw,    offset 0   [x, o0, o1, o2]       y  -> global
//
// (offset: the region starts that many rows/cols above/left of the tile).
// The layout parameter PACKED only changes where pixel (b, gy, gx) of x and y
// lies in memory (fb_pixel); the c channels of one pixel are contiguous in
// both layouts, so the arithmetic is the same.
// x is read from global memory (through L1/L2); o0..o2 live only in shared
// memory.  Samples of o0..o2 that lie outside the image are stored as zero,
// in rows AND columns, so each nested SAME conv sees exactly the zero padding
// of the unfused block.  Rounding follows the TPU kernel: f32 accumulation,
// bias added in f32, one cast to T, PReLU in T, residual add in T.

#pragma once

#include <cuda_bf16.h>

#define FB_DEVICE __device__ __forceinline__

// Element conversions; from_f rounds to nearest even.
FB_DEVICE float to_f(float v) { return v; }
FB_DEVICE float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> FB_DEVICE T from_f(float v);
template <> FB_DEVICE float from_f<float>(float v) { return v; }
template <> FB_DEVICE __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

struct BlockArgs {
    const void* x;      // (n, h, w, c) NHWC, or (n, h/2, w/2, 4c) even-packed; type T
    const void* wgt;    // conv_0..conv_3 tap-major (9, K_i, N_i), type T
    const float* ba;    // bias_0..bias_3 then alpha_0..alpha_3, f32
    void* y;            // laid out like x, element type T
    int n, h, w, c, inner, th, tw;  // h, w: the image's (unpacked) size
};

// Element offset of channel 0 of image pixel (b, gy, gx).  NHWC, or with
// PACKED the even-packed layout: packed pixel (gy/2, gx/2), channel
// (a*2 + b')*c + k for sub-pixel a = gy&1, b' = gx&1 (h and w even).
template <bool PACKED>
FB_DEVICE long long fb_pixel(const BlockArgs& a, int b, int gy, int gx) {
    if (PACKED) {
        const long long q = ((long long)b * (a.h >> 1) + (gy >> 1)) * (a.w >> 1) + (gx >> 1);
        return q * 4 * a.c + ((gy & 1) * 2 + (gx & 1)) * a.c;
    }
    return (((long long)b * a.h + gy) * a.w + gx) * a.c;
}

// Offsets into the packed weight buffer and the bias/alpha buffer.
FB_DEVICE long long fb_weight_offset(int c, int inner, int level) {
    long long off = 0;
    for (int i = 0; i < level; ++i) off += 9LL * (c + i * inner) * inner;
    return off;
}

// One level for the work items of thread `tid` out of `nthreads`.
// A work item is P consecutive positions of the level's region and one output
// channel; neighbouring threads take neighbouring channels, so their weight
// reads coalesce and their activation reads broadcast.
template <typename T, int P, bool PACKED>
FB_DEVICE void fb_level(const BlockArgs& a, int level, int y0, int x0, int b,
                        T* smem, int tid, int nthreads) {
    const int c = a.c, inner = a.inner;
    const int rh = a.th + 6 - 2 * level, rw = a.tw + 6 - 2 * level;
    const int m_total = rh * rw;
    const int kin = c + level * inner;
    const int nout = level < 3 ? inner : c;
    const T* xg = static_cast<const T*>(a.x);
    const T* wl = static_cast<const T*>(a.wgt) + fb_weight_offset(c, inner, level);
    const int bias_off = level * inner;
    const int alpha_off = 3 * inner + c + level * inner;
    // shared-memory offsets of o0, o1, o2
    long long s_off[3];
    s_off[0] = 0;
    s_off[1] = s_off[0] + (long long)(a.th + 6) * (a.tw + 6) * inner;
    s_off[2] = s_off[1] + (long long)(a.th + 4) * (a.tw + 4) * inner;

    const int groups = (m_total + P - 1) / P;
    const int items = groups * nout;
    for (int item = tid; item < items; item += nthreads) {
        const int o = item % nout;
        const int m0 = (item / nout) * P;
        int pr[P], pc[P];
        float acc[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const int m = m0 + p < m_total ? m0 + p : m_total - 1;
            pr[p] = m / rw;
            pc[p] = m % rw;
            acc[p] = 0.f;
        }
        for (int dy = 0; dy < 3; ++dy) {
            for (int dx = 0; dx < 3; ++dx) {
                const T* wt = wl + (long long)(dy * 3 + dx) * kin * nout + o;
                // x part of the concat: global memory, zero outside the image
                const T* xp[P];
                bool ok[P];
#pragma unroll
                for (int p = 0; p < P; ++p) {
                    const int gy = y0 - 3 + level + pr[p] + dy - 1;
                    const int gx = x0 - 3 + level + pc[p] + dx - 1;
                    ok[p] = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
                    xp[p] = xg + fb_pixel<PACKED>(a, b, ok[p] ? gy : 0, ok[p] ? gx : 0);
                }
                for (int k = 0; k < c; ++k) {
                    const float wv = to_f(wt[(long long)k * nout]);
#pragma unroll
                    for (int p = 0; p < P; ++p) {
                        const float xv = ok[p] ? to_f(xp[p][k]) : 0.f;
                        acc[p] = fmaf(xv, wv, acc[p]);
                    }
                }
                // o_j parts: shared memory, already zero outside the image
                for (int j = 0; j < level; ++j) {
                    const int rwj = a.tw + 6 - 2 * j;
                    const T* sp[P];
#pragma unroll
                    for (int p = 0; p < P; ++p) {
                        const int r = pr[p] + dy - 1 + level - j;
                        const int s = pc[p] + dx - 1 + level - j;
                        sp[p] = smem + s_off[j] + ((long long)r * rwj + s) * inner;
                    }
                    const T* wj = wt + (long long)(c + j * inner) * nout;
                    for (int k = 0; k < inner; ++k) {
                        const float wv = to_f(wj[(long long)k * nout]);
#pragma unroll
                        for (int p = 0; p < P; ++p) acc[p] = fmaf(to_f(sp[p][k]), wv, acc[p]);
                    }
                }
            }
        }
        // epilogue: bias in f32, cast to T, PReLU in T, then store
        const float bias = a.ba[bias_off + o];
        const float alpha = to_f(from_f<T>(a.ba[alpha_off + o]));
#pragma unroll
        for (int p = 0; p < P; ++p) {
            if (m0 + p >= m_total) continue;
            float v = to_f(from_f<T>(acc[p] + bias));
            if (!(v > 0.f)) v = to_f(from_f<T>(alpha * v));
            const int gy = y0 - 3 + level + pr[p];
            const int gx = x0 - 3 + level + pc[p];
            const bool inside = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
            if (level < 3) {
                smem[s_off[level] + ((long long)pr[p] * rw + pc[p]) * inner + o] =
                    from_f<T>(inside ? v : 0.f);
            } else if (inside) {
                const long long at = fb_pixel<PACKED>(a, b, gy, gx) + o;
                static_cast<T*>(a.y)[at] = from_f<T>(v + to_f(xg[at]));
            }
        }
    }
}
