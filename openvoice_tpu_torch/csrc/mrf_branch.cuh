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
// halo (stage_halo in ops/mrf_cuda.py) covers the deepest branch.  Each
// kernel runs the chains with its own product loop and computes each conv
// only on the rows the later convs of its branch read (mrf.cu's
// stage_branches, tail.cu's tail_branches).

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
