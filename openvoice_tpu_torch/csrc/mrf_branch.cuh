// The multi-receptive-field branch chains on a time window held in shared
// memory, shared by the MRF-stage kernel (mrf.cu, K3) and the decoder-tail
// kernel (tail.cu, K4).
//
// openvoice_tpu/ops/mrf_pallas.py::_run_branches, sequential order: for each
// ResBlock1 branch (kernel size k, one conv pair per dilation d), from the
// stage input x0:
//   xt = lrelu(xb) * mask                      bf16, slope 0.1
//   y  = conv(xt, k, dilation d) + bias        f32
//   xt = lrelu(bf16(y)) * mask
//   y2 = conv(xt, k, dilation 1) + bias        f32
//   xb = xb + bf16(y2)                         bf16
// and the stage's result is ((b0 + b1) + b2) / n_branches over the masked
// branch outputs, widened to f32.  A finished branch's output is parked in
// device memory (as the bf16 values it consists of, so nothing is lost) until
// the last branch sums them: shared memory is what limits the window, and
// this keeps the sum out of it.
//
// Window row i is sample pos0 + i; samples outside [0, length) are held at
// zero before every conv and on every residual (biases break zero
// propagation).  The running residual is stored masked, which changes nothing
// (every use of it is masked) and lets the first conv of a pair apply its
// leaky ReLU to the A fragments in registers instead of to a third buffer.
// Rows near the window's edge go stale by each conv's reach; the caller's
// halo (stage_halo in ops/mrf_cuda.py) covers the deepest branch.

#pragma once

#include "mma_tile.cuh"

namespace ovt {

constexpr int MAX_BRANCHES = 4;
constexpr int MAX_PAIRS = 4;

struct MrfMeta {
    int n_branches, n_pairs;
    int ksize[MAX_BRANCHES];
    int dilation[MAX_BRANCHES][MAX_PAIRS];
};

struct MrfWindow {
    bf16* xb;       // [rows][ld] running residual of the current branch, masked
    bf16* xt;       // [rows][ld] activated operand of the second conv of a pair
    bf16* parked;   // [n_branches - 1][acc_rows][chan] finished branches' outputs (device memory)
    const bf16* zero_row;
    int rows, ld, chan;
    int acc_row0, acc_rows;  // window rows whose result is kept
    int pos0, length;
};

// wfrag: every conv's taps in execution order (branch, pair, first | second
// conv), each tap a [C/16][C/8][32] fragment matrix; bias [n_convs][C] bf16.
// load_x0() fills w.xb with the masked stage input (every thread calls it; no
// barrier needed inside).  result(row, col, m0, m1) receives the stage's
// result for rows acc_row0 .. acc_row0 + acc_rows, once per element pair.
// Ends with a barrier.
template <typename LoadX0, typename Result>
__device__ __forceinline__ void mrf_branches(const MrfWindow& w, const MrfMeta& meta,
                                             const uint2* __restrict__ wfrag,
                                             const bf16* __restrict__ bias, LoadX0 load_x0,
                                             Result result) {
    const int c = w.chan;
    const size_t tap_words = static_cast<size_t>(c >> 4) * (c >> 3) * 32;
    const int m_chunks = w.rows / TILE_ROWS;
    const float slope_f = __bfloat162float(__float2bfloat16_rn(0.1f));
    const bf162 slope = __float2bfloat162_rn(0.1f);
    const float n_br = static_cast<float>(meta.n_branches);
    auto live = [&](int row) { const int p = w.pos0 + row; return p >= 0 && p < w.length; };

    for (int br = 0; br < meta.n_branches; ++br) {
        load_x0();
        __syncthreads();
        const int k = meta.ksize[br], half = (k - 1) / 2;
        for (int pair = 0; pair < meta.n_pairs; ++pair) {
            const int d = meta.dilation[br][pair];
            conv_rows<true>(w.xb, w.ld, w.rows, 0, m_chunks, c, w.zero_row, wfrag, c, k, -half * d, d,
                            0, 1, bias, slope, [&](int row, int col, float v0, float v1) {
                                const bool ok = live(row);
                                const float a0 = ok ? lrelu_bf16(round_bf16(v0), slope_f) : 0.f;
                                const float a1 = ok ? lrelu_bf16(round_bf16(v1), slope_f) : 0.f;
                                *reinterpret_cast<bf162*>(w.xt + static_cast<size_t>(row) * w.ld + col) =
                                    __floats2bfloat162_rn(a0, a1);
                            });
            wfrag += k * tap_words;
            bias += c;
            __syncthreads();
            const bool last_pair = pair == meta.n_pairs - 1;
            conv_rows<false>(w.xt, w.ld, w.rows, 0, m_chunks, c, w.zero_row, wfrag, c, k, -half, 1, 0,
                             1, bias, slope, [&](int row, int col, float v0, float v1) {
                                 bf162* px = reinterpret_cast<bf162*>(w.xb + static_cast<size_t>(row) * w.ld + col);
                                 float n0 = 0.f, n1 = 0.f;
                                 if (live(row)) {
                                     const float2 cur = __bfloat1622float2(*px);
                                     n0 = round_bf16(cur.x + round_bf16(v0));
                                     n1 = round_bf16(cur.y + round_bf16(v1));
                                 }
                                 *px = __floats2bfloat162_rn(n0, n1);
                                 const int arow = row - w.acc_row0;
                                 if (last_pair && arow >= 0 && arow < w.acc_rows) {
                                     // a finished branch's output is parked as the bf16 it
                                     // is; the last branch adds them up in f32, in order.
                                     // Each thread reads back only what it wrote itself.
                                     bf16* park = w.parked + static_cast<size_t>(arow) * c + col;
                                     const size_t slot = static_cast<size_t>(w.acc_rows) * c;
                                     if (br < meta.n_branches - 1) {
                                         *reinterpret_cast<bf162*>(park + br * slot) = __floats2bfloat162_rn(n0, n1);
                                     } else {
                                         float s0 = 0.f, s1 = 0.f;
                                         for (int i = 0; i < br; ++i) {
                                             const float2 p = __bfloat1622float2(
                                                 *reinterpret_cast<const bf162*>(park + i * slot));
                                             s0 += p.x;
                                             s1 += p.y;
                                         }
                                         result(row, col, (s0 + n0) / n_br, (s1 + n1) / n_br);
                                     }
                                 }
                             });
            wfrag += k * tap_words;
            bias += c;
            __syncthreads();
        }
    }
}

inline MrfMeta make_meta(int n_branches, int n_pairs, const int* ksizes, const int* dilations) {
    MrfMeta meta;
    meta.n_branches = n_branches;
    meta.n_pairs = n_pairs;
    for (int b = 0; b < MAX_BRANCHES; ++b) {
        meta.ksize[b] = b < n_branches ? ksizes[b] : 1;
        for (int p = 0; p < MAX_PAIRS; ++p)
            meta.dilation[b][p] = (b < n_branches && p < n_pairs) ? dilations[b * n_pairs + p] : 1;
    }
    return meta;
}

}  // namespace ovt
