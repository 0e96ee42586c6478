// What the two decoder kernels share: K3 (mrf.cu, the MRF stages) and K4
// (tail.cu, the stages with their upsample).  Both compute the mean of a
// stage's ResBlock1 branches on a time window held in shared memory, every
// product on Hopper's warpgroup MMA with its weights streamed through shared
// memory.  Shared here: the product loop over 64-row tiles (`conv_wgmma`)
// and the branch loop (`mrf_branches`), on the weight ring of ring.cuh
// (which K1 and K2 share too).  Each
// kernel keeps its own window layout, which sets its window and ring depth
// and reaches the loops as a template policy (`Rows`: K3's XOR-swizzled
// rows, K4's padded rows), its staging of the stage input, its result store
// and its entry; K4 also its upsample, conv_post and early exit.
//
// The branches, openvoice_tpu/ops/mrf_pallas.py::_run_branches in sequential
// order: for each ResBlock1 branch (kernel size k, one conv pair per
// dilation d), from the stage input x0:
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
// halo (stage_halo in ops/mrf_cuda.py) covers the deepest branch.  Each conv
// is computed only on the rows the later convs of its branch read: 64-row
// tiles placed from the first row of its range (ops/mrf_cuda.py::conv_tiles).
// The last tile of a range may reach past it; those rows, like every row
// outside a range, hold stale values, which only rows outside the next conv's
// range read, and never reach the kept rows.
//
// Products (wgmma.cuh): a warpgroup computes one 64-row x N-column item a
// round (N = C, or C split in N-wide parts), one m64nNk16 per tap and k-tile,
// with A, the shifted rows, from registers (ldmatrix takes a row address a
// lane, so a tap's shift and dilation need no 8-row alignment, and the first
// conv of a pair applies its leaky ReLU to the fragments) and B from the ring.
// ptxas serialises every product of a warpgroup whose A registers are written
// while one of its products runs, so a warpgroup loads the fragments of up to
// part_max(N) slabs, issues their products back to back and waits for them
// (`products`): the warpgroups overlap one another's loads and products, not
// their own.  The ring's group, G slabs, is a constant of each kernel's
// instance (K3: 2 at N = 256, 4 below; K4: 16 KB of slabs).

#pragma once

#include "mma_tile.cuh"
#include "ring.cuh"
#include "wgmma.cuh"

#include <type_traits>

namespace ovt {

constexpr int MAX_BRANCHES = 4;
constexpr int MAX_PAIRS = 4;
constexpr int MAX_CONVS = MAX_BRANCHES * MAX_PAIRS * 2;
constexpr int MAX_PHASES = 8;                    // K4's upsample stride at most
static_assert(MAX_PHASES + MAX_CONVS <= MAX_SEQ, "K4's phases and convs are entries of one ring plan");

// Slabs whose products a warpgroup issues between waits: its fragments (4
// registers a slab) live beside its N / 2 accumulators.
__host__ __device__ constexpr int part_max(int n) { return n >= 256 ? 2 : n >= 128 ? 4 : 8; }

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

// -- the products --------------------------------------------------------------

// P slabs' products of one warpgroup, back to back: acc += A rows @ slab for
// the next P steps (tap, k-tile) from (tap, kt), which advance.  Every
// fragment loads before the first product and the warpgroup waits for the
// last, as ptxas asks of A in registers.  This lane's A row at tap i is
// row_base + i * shift_step, its 8 columns half lchunk of the k-tile (at
// Rows::frag); rows outside [0, a_rows) read `zero_row` there.
template <int N, int P, bool LRELU, typename Rows>
__device__ __forceinline__ void products(float (&acc)[N / 2], const bf16* a, int lda, int a_rows, int row_base,
                                         int shift_step, const bf16* zero_row, int lchunk, int k_tiles, int& tap,
                                         int& kt, uint32_t slab, int slab_bytes, bf162 slope) {
    uint32_t af[P][4];
#pragma unroll
    for (int q = 0; q < P; ++q) {
        const int row = row_base + tap * shift_step;
        const bf16* arow = (row >= 0 && row < a_rows) ? a + static_cast<size_t>(row) * lda : zero_row;
        ldmatrix_x4(af[q], arow + Rows::frag(row, kt, lchunk));
        if (LRELU) {
#pragma unroll
            for (int e = 0; e < 4; ++e) af[q][e] = lrelu_pair(af[q][e], slope);
        }
        if (++kt == k_tiles) {
            kt = 0;
            ++tap;
        }
    }
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < P; ++q) Wgmma<N>::mma(acc, af[q], b_desc(slab + q * slab_bytes));
    wgmma_commit();
    wgmma_wait<0>();
}

// Entry e of the plan as a block-wide convolution over its tiles:
//   y[r, n] = bias[n] + sum_i A[r + shift0 + i * shift_step, :] @ W_i[:, n]
// with k_tiles k-tiles a tap and `chan` output columns (chan / N parts of a
// tile), its slabs from the ring in groups of G.  A is `a_rows` rows of `lda`
// in the layout Rows.  An item is one tile's N-column part; warpgroup w takes
// item w of each round of WGS, and a warpgroup without an item walks the ring
// alone.  A group's products go in parts of min(G, part_max(N)) slabs; a
// round's last group, where it is shorter, in parts of powers of two.  Its
// waits are unconditional on its own path, so ptxas proves every fragment
// rewrite and accumulator read ordered after the products that used them.
// The group is a constant of the instance: a group size read at run time
// keeps a loop and its count live beside the accumulators, which at N = 256
// (128 accumulators a thread) spilled.  Each element pair (r, n), (r, n + 1)
// goes once through store(r, n, y0, y1).  No block barrier inside.
template <int N, int WGS, int G, bool LRELU, typename Rows, typename Store>
__device__ __forceinline__ void conv_wgmma(const bf16* a, int lda, int a_rows, int k_tiles, const bf16* zero_row,
                                           int shift0, int shift_step, int chan, const bf16* bias, bf162 slope,
                                           Ring& ring, const RingPlan& plan, int e, Store store) {
    constexpr int P = G < part_max(N) ? G : part_max(N);
    static_assert(G <= 2 * P, "a short group's largest part must fit the products between waits");
    // the warpgroup, as a value the compiler knows is alike across the warp
    const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
    const int lane = threadIdx.x & 31;
    const int wrow = ((threadIdx.x >> 5) & 3) * 16;  // this warp's 16 rows of the tile
    const int lchunk = lane >> 4;
    const int first = plan.first[e], count = plan.count[e], steps = plan.steps[e];
    const int parts = chan / N, n_items = count * parts;
    for (int round0 = 0; round0 < n_items; round0 += WGS) {
        const int item = round0 + wg;
        if (item >= n_items) {
            for (int s = 0; s < steps; s += G) {
                ring_wait(ring, plan, e, s);
                ring_release(ring, plan, e);
            }
            continue;
        }
        const int part = parts > 1 ? item / count : 0;
        const int row0 = first + (item - part * count) * TILE_M;
        const int row_base = row0 + wrow + (lane & 15) + shift0;  // this lane's A row at tap 0
        const uint32_t b_off = static_cast<uint32_t>(part) * N * 32;
        float acc[N / 2];
#pragma unroll
        for (int q = 0; q < N / 2; ++q) acc[q] = 0.f;
        int tap = 0, kt = 0;
        auto issue = [&](auto parts_of, uint32_t slab) {
            constexpr int Q = decltype(parts_of)::value;
            products<N, Q, LRELU, Rows>(acc, a, lda, a_rows, row_base, shift_step, zero_row, lchunk, k_tiles, tap,
                                        kt, slab, ring.slab_bytes, slope);
        };
        for (int s = 0; s < steps; s += G) {
            uint32_t slab = ring_wait(ring, plan, e, s) + b_off;
            const int left = steps - s;
            if (left >= G) {
                // a loop, not unrolled: K4's 16-slab groups in two parts keep fewer registers live
#pragma unroll 1
                for (int q = 0; q < G; q += P) issue(std::integral_constant<int, P>(), slab + q * ring.slab_bytes);
            } else {
                if constexpr (G > 8) {
                    if (left & 8) { issue(std::integral_constant<int, 8>(), slab); slab += 8 * ring.slab_bytes; }
                }
                if constexpr (G > 4) {
                    if (left & 4) { issue(std::integral_constant<int, 4>(), slab); slab += 4 * ring.slab_bytes; }
                }
                if constexpr (G > 2) {
                    if (left & 2) { issue(std::integral_constant<int, 2>(), slab); slab += 2 * ring.slab_bytes; }
                }
                if constexpr (G > 1) {
                    if (left & 1) issue(std::integral_constant<int, 1>(), slab);
                }
            }
            ring_release(ring, plan, e);
        }
        fence_acc(acc);
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
            const int col = part * N + j * 8 + (lane & 3) * 2;
            const float2 bc = __bfloat1622float2(*reinterpret_cast<const bf162*>(bias + col));
#pragma unroll
            for (int half = 0; half < 2; ++half)
                store(row0 + wrow + (lane >> 2) + half * 8, col, acc[4 * j + 2 * half] + bc.x,
                      acc[4 * j + 2 * half + 1] + bc.y);
        }
    }
}

// -- the branch loop -----------------------------------------------------------

// The branch chains on the window, MRF conv cv as plan entry e0 + cv; bias
// [n_convs][chan].  load_x0() fills w.xb with the masked stage input (every
// thread calls it; no barrier needed inside).  result(row, col, m0, m1)
// receives the stage's result for rows acc_row0 .. acc_row0 + acc_rows, once
// per element pair.  Ends with a barrier.
template <int N, int WGS, int G, typename Rows, typename LoadX0, typename Result>
__device__ __forceinline__ void mrf_branches(const MrfWindow& w, const MrfMeta& meta, const RingPlan& plan, int e0,
                                             Ring& ring, const bf16* bias, LoadX0 load_x0, Result result) {
    const int c = w.chan;
    const bf162 slope = __float2bfloat162_rn(0.1f);
    const float n_br = static_cast<float>(meta.n_branches);
    auto live = [&](int row) { const int p = w.pos0 + row; return p >= 0 && p < w.length; };
    auto at = [&](int row, int col) { return static_cast<size_t>(row) * w.ld + Rows::col(row, col); };
    int cv = 0;

    for (int br = 0; br < meta.n_branches; ++br) {
        load_x0();
        __syncthreads();
        const int k = meta.ksize[br], half = (k - 1) / 2;
        for (int pair = 0; pair < meta.n_pairs; ++pair, cv += 2) {
            const int d = meta.dilation[br][pair];
            conv_wgmma<N, WGS, G, true, Rows>(w.xb, w.ld, w.rows, c / 16, w.zero_row, -half * d, d, c, bias, slope,
                                           ring, plan, e0 + cv, [&](int row, int col, float v0, float v1) {
                                               // bf16(y), then the leaky ReLU on the pair: the
                                               // product rounds once, as lrelu_bf16's does
                                               const bf162 y = __floats2bfloat162_rn(v0, v1);
                                               const uint32_t a = live(row) ? lrelu_pair(
                                                   *reinterpret_cast<const uint32_t*>(&y), slope) : 0u;
                                               *reinterpret_cast<uint32_t*>(w.xt + at(row, col)) = a;
                                           });
            bias += c;
            __syncthreads();
            const bool last_pair = pair == meta.n_pairs - 1;
            conv_wgmma<N, WGS, G, false, Rows>(
                w.xt, w.ld, w.rows, c / 16, w.zero_row, -half, 1, c, bias, slope, ring, plan, e0 + cv + 1,
                [&](int row, int col, float v0, float v1) {
                    bf162* px = reinterpret_cast<bf162*>(w.xb + at(row, col));
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
                                const float2 p = __bfloat1622float2(*reinterpret_cast<const bf162*>(park + i * slot));
                                s0 += p.x;
                                s1 += p.y;
                            }
                            result(row, col, (s0 + n0) / n_br, (s1 + n1) / n_br);
                        }
                    }
                });
            bias += c;
            __syncthreads();
        }
    }
}

}  // namespace ovt
