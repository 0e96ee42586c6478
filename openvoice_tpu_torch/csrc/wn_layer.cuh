// One WaveNet layer on a time window held in shared memory, shared by the
// WaveNet-stack kernel (wn.cu, K1) and the coupling-block kernel
// (coupling.cu, K2).
//
// The layer (openvoice_tpu/ops/wn_pallas.py::_wn_kernel):
//   x_in = sum_k xs[t + k - pad] @ W_in[k] + b_in + g        f32
//   acts = bf16(tanh(x_in[:, :H]) * sigmoid(x_in[:, H:]))
//   rs   = acts @ W_rs + b_rs                                  f32
//   xs   = bf16(xs + bf16(rs[:, :H])) * mask                   unless last layer
//   skip = skip + rs[:, H:]                                    f32
//
// The window holds `rows` consecutive frames; window row i is frame
// frame0 + i.  Rows whose frame lies outside [0, length) are held at zero at
// every layer (they are the convolution's zero padding and the padded part of
// a batch row).  Rows outside the window read as zero too, which is wrong for
// frames that exist, so rows near the window's edge go stale by `pad` rows a
// layer: the caller sizes the window's halo to the layers' reach and keeps
// only the rows in the middle.

#pragma once

#include "mma_tile.cuh"

namespace ovt {

struct WnWindow {
    bf16* xs;         // [rows][ld] residual state
    bf16* acts;       // [rows][ld] gate output
    float* skip;      // [skip_rows][hidden] skip sum of window rows skip_row0 ..
    const bf16* zero_row;
    int rows, ld, hidden, ksize;
    int skip_row0, skip_rows;
    int frame0, length;
};

// w_in: this layer's taps in fragment order [K][H/16][2H/8][32]; b_in, g,
// b_rs: [2H] bf16; w_rs: [H/16][2H/8][32].  first: skip is written, not added
// to.  last: the residual is not updated (its res half is packed as zeros).
// Ends with a barrier.
__device__ __forceinline__ void wn_layer(const WnWindow& w, const uint2* __restrict__ w_in,
                                         const bf16* __restrict__ b_in, const bf16* __restrict__ g,
                                         const uint2* __restrict__ w_rs,
                                         const bf16* __restrict__ b_rs, bool first, bool last) {
    const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
    const int lane = threadIdx.x & 31;
    const int h = w.hidden, h_tiles = h >> 3, n_tiles = 2 * h_tiles;
    const int m_chunks = w.rows / TILE_ROWS;
    const int pad = (w.ksize - 1) / 2;
    const size_t tap_words = static_cast<size_t>(h >> 4) * n_tiles * 32;
    const bf162 slope0 = no_slope();

    // dilated conv + gate: a warp tile pairs two tanh column tiles with the
    // two sigmoid column tiles of the same channels
    const int gate_groups = (h_tiles + 1) / 2;
    for (int item = warp; item < m_chunks * gate_groups; item += n_warps) {
        const int gg = item / m_chunks, mc = item % m_chunks;
        const int t0 = 2 * gg, t1 = (2 * gg + 1 < h_tiles) ? 2 * gg + 1 : -1;
        const int nt[NT] = {t0, t1, h_tiles + t0, t1 < 0 ? -1 : h_tiles + t1};
        Acc acc;
        zero_acc(acc);
        for (int k = 0; k < w.ksize; ++k)
            warp_gemm<false>(acc, w.xs, w.ld, w.rows, mc * TILE_ROWS + k - pad, w.zero_row, h,
                             w_in + k * tap_words, n_tiles, nt, slope0);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            if (nt[j] < 0) continue;
            const int col = nt[j] * 8 + (lane & 3) * 2;
            const float bt0 = __bfloat162float(b_in[col]), bt1 = __bfloat162float(b_in[col + 1]);
            const float bs0 = __bfloat162float(b_in[h + col]), bs1 = __bfloat162float(b_in[h + col + 1]);
            const float gt0 = __bfloat162float(g[col]), gt1 = __bfloat162float(g[col + 1]);
            const float gs0 = __bfloat162float(g[h + col]), gs1 = __bfloat162float(g[h + col + 1]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int row = mc * TILE_ROWS + mt * 16 + (lane >> 2) + half * 8;
                    const float a0 = tanhf(acc[mt][j][2 * half] + bt0 + gt0) *
                                     sigmoidf_(acc[mt][j + 2][2 * half] + bs0 + gs0);
                    const float a1 = tanhf(acc[mt][j][2 * half + 1] + bt1 + gt1) *
                                     sigmoidf_(acc[mt][j + 2][2 * half + 1] + bs1 + gs1);
                    *reinterpret_cast<bf162*>(w.acts + static_cast<size_t>(row) * w.ld + col) =
                        __floats2bfloat162_rn(a0, a1);
                }
            }
        }
    }
    __syncthreads();

    // res|skip 1x1: column tiles [0, h_tiles) are the res half, the rest skip
    const int n_groups = (n_tiles + NT - 1) / NT;
    for (int item = warp; item < m_chunks * n_groups; item += n_warps) {
        const int ng = item / m_chunks, mc = item % m_chunks;
        int nt[NT];
        bool any = false;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const int t = ng * NT + j;
            nt[j] = (t < n_tiles && !(last && t < h_tiles)) ? t : -1;
            any |= nt[j] >= 0;
        }
        if (!any) continue;
        Acc acc;
        zero_acc(acc);
        warp_gemm<false>(acc, w.acts, w.ld, w.rows, mc * TILE_ROWS, w.zero_row, h, w_rs, n_tiles, nt,
                         slope0);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            if (nt[j] < 0) continue;
            const int col = nt[j] * 8 + (lane & 3) * 2;
            const float b0 = __bfloat162float(b_rs[col]), b1 = __bfloat162float(b_rs[col + 1]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int row = mc * TILE_ROWS + mt * 16 + (lane >> 2) + half * 8;
                    const float v0 = acc[mt][j][2 * half] + b0, v1 = acc[mt][j][2 * half + 1] + b1;
                    if (col < h) {
                        const int frame = w.frame0 + row;
                        bf162* px = reinterpret_cast<bf162*>(w.xs + static_cast<size_t>(row) * w.ld + col);
                        if (frame >= 0 && frame < w.length) {
                            const float2 x = __bfloat1622float2(*px);
                            *px = __floats2bfloat162_rn(x.x + round_bf16(v0), x.y + round_bf16(v1));
                        } else {
                            *px = __float2bfloat162_rn(0.f);
                        }
                    } else {
                        const int srow = row - w.skip_row0;
                        if (srow >= 0 && srow < w.skip_rows) {
                            float* ps = w.skip + static_cast<size_t>(srow) * h + (col - h);
                            if (first) {
                                ps[0] = v0;
                                ps[1] = v1;
                            } else {
                                ps[0] += v0;
                                ps[1] += v1;
                            }
                        }
                    }
                }
            }
        }
    }
    __syncthreads();
}

}  // namespace ovt
