// What the two decoder kernels share: K3 (mrf.cu, the MRF stages) and K4
// (tail.cu, the stages with their upsample).  Both compute the mean of a
// stage's ResBlock1 branches on a time window held in shared memory, every
// product on Hopper's warpgroup MMA with its weights streamed through shared
// memory.  Shared here: the weight ring (`Ring`, `RingPlan`, `make_plan`,
// `ring_start`, `ring_copy`, `ring_wait`, `ring_release`), the product loop
// over 64-row tiles (`conv_wgmma`) and the branch loop (`mrf_branches`).  Each
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

#include "bulk_copy.cuh"
#include "mma_tile.cuh"
#include "wgmma.cuh"

#include <type_traits>

namespace ovt {

constexpr int MAX_BRANCHES = 4;
constexpr int MAX_PAIRS = 4;
constexpr int MAX_CONVS = MAX_BRANCHES * MAX_PAIRS * 2;
constexpr int MAX_PHASES = 8;                    // K4's upsample stride at most
constexpr int MAX_SEQ = MAX_PHASES + MAX_CONVS;  // product entries a launch
constexpr int TILE_M = 64;                       // rows of one wgmma tile
constexpr int MAX_GROUP = 16;                    // slabs of one ring group
constexpr int MAX_STAGES = 32;                   // groups the ring holds at most
constexpr int SLAB_ALIGN = 256;                  // the 32-byte swizzle's period: slabs start on it
constexpr int PLAN_FIELDS = 5;                   // a plan entry from the host: first, count, steps, slab0, group_end

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

// -- the weight ring -----------------------------------------------------------
//
// A slab is one (tap, k-tile) of a conv's weights, the [16, C] B tile of
// wgmma.cuh, 32 * C bytes.  A launch's slabs are one stream in execution
// order, and its products are entries (K4: the upsample's phases, then the
// MRF convs; K3: the MRF convs); a round of an entry is one item a
// warpgroup, and every warp walks every group of every round.  The ring
// moves the stream a group at a time: group p of entry e (each of its rounds
// has ceil(steps / group) groups) is slabs [q * group, ...) of the entry's,
// q = p's index in its round, as one bulk copy into stage p % stages (a round
// whose slabs are not a multiple of the group ends on a shorter one).  The
// stage's "full" barrier completes when the bytes land, its "empty" barrier
// when every warp has released the group.  A warp releases a group once its
// own products on it have completed; the warp whose turn it is then waits
// until every warp has released it and copies group p + stages into its
// stage: the warps take the copies in turn, so that copies issued by
// different warps run at once (one thread's bulk copies complete one after
// another, about 450 cycles apart on an H100), and the copies run ahead of
// the reads across rounds, entries and block barriers.  (A release that lets
// the last warp to release refill at once, without waiting, measured slower
// on an H100: PERF.md.)  With stages == 0 the whole stream is resident and
// nothing is waited for or released.

// The host's plan of a launch (ops/mrf_cuda.py::ring_plan), in the kernel's
// parameters.
struct RingPlan {
    int first[MAX_SEQ];      // window (K4's phases: phase) row of the entry's first tile
    int count[MAX_SEQ];      // its 64-row tiles
    int steps[MAX_SEQ];      // slabs a round: taps x k-tiles
    int slab0[MAX_SEQ];      // its first slab in the stream
    int group_end[MAX_SEQ];  // ring groups of entries 0 .. e, every round
    int total;               // ring groups in all
    int slabs;               // the stream's slabs
    int stages;              // ring stages, a group each; 0: the stream is resident
    int ring_slabs;          // slabs the ring's area holds
};

// Shared memory of a ring: its slabs (or the resident stream) and two
// barriers a stage (one pair for a resident stream).  A multiple of 16.
__host__ __device__ __forceinline__ long long ring_bytes(int slab_bytes, int ring_slabs, int stages) {
    return (long long)ring_slabs * slab_bytes + 16LL * (stages > 0 ? stages : 1);
}

// The plan from the host's table [entries][PLAN_FIELDS], for a ring of
// `stages` groups of `group` slabs.  An entry's items are its tiles times
// `parts` (N-column parts of a tile).  Returns false
// unless every tile lies in [0, rows), the stream is contiguous, each entry
// ends on its rounds times its groups a round, and the ring's shape is one
// the kernels take: the warps walk exactly these groups, so a wrong count
// would leave them waiting for a copy that never comes.
inline bool make_plan(RingPlan& plan, const int* table, int entries, int rows, int parts, int warpgroups,
                      int stages, int group) {
    if (entries < 1 || entries > MAX_SEQ || stages < 0 || stages > MAX_STAGES || group < 1 || group > MAX_GROUP)
        return false;
    int slabs = 0, groups = 0;
    for (int e = 0; e < entries; ++e) {
        const int* t = table + PLAN_FIELDS * e;
        const int first = t[0], count = t[1], steps = t[2];
        groups += (count * parts + warpgroups - 1) / warpgroups * ((steps + group - 1) / group);
        if (first < 0 || count < 1 || first + count * TILE_M > rows || steps < 1 || t[3] != slabs ||
            t[4] != groups)
            return false;
        plan.first[e] = first;
        plan.count[e] = count;
        plan.steps[e] = steps;
        plan.slab0[e] = slabs;
        plan.group_end[e] = groups;
        slabs += steps;
    }
    plan.total = groups;
    plan.slabs = slabs;
    plan.stages = stages;
    plan.ring_slabs = stages > 0 ? stages * group : slabs;
    return true;
}

// Shared addresses (smem_u32): the slabs, [stages][group slabs] or the whole
// stream, then the barriers, full[stages] and empty[stages] (resident: one
// pair).
struct Ring {
    uint32_t slabs, bars;
    const unsigned char* wsrc;  // the stream in device memory
    int stages, group, slab_bytes, n_warps;
    int stage;                  // the stage this warp reads next
    uint32_t phase;             // its parity
    int r, r_stage;             // the group this warp releases next, and its stage
    uint32_t r_phase;
    int turn_in;                // releases until this warp's turn to refill: 0 when it refills group r's stage
};

__device__ __forceinline__ uint32_t full_bar(const Ring& ring, int stage) { return ring.bars + 8 * stage; }

__device__ __forceinline__ uint32_t empty_bar(const Ring& ring, int stage) {
    return ring.bars + 8 * (ring.stages + stage);
}

// One thread: copy group p into `stage`.  `e` is an entry at or before p's.
__device__ __forceinline__ void ring_copy(const Ring& ring, const RingPlan& plan, int p, int stage, int e) {
    if (p >= plan.total) return;
    while (p >= plan.group_end[e]) ++e;
    const int start = e ? plan.group_end[e - 1] : 0;
    const int q = (p - start) % ((plan.steps[e] + ring.group - 1) / ring.group);  // its index in its round
    const int n = min(ring.group, plan.steps[e] - q * ring.group);
    const uint32_t bytes = static_cast<uint32_t>(n * ring.slab_bytes);
    mbar_expect_tx(full_bar(ring, stage), bytes);
    bulk_copy(ring.slabs + stage * ring.group * ring.slab_bytes,
              ring.wsrc + static_cast<size_t>(plan.slab0[e] + q * ring.group) * ring.slab_bytes, bytes,
              full_bar(ring, stage));
}

// The ring of `plan` at `smem` (256-byte aligned), streaming `wsrc`; slabs of
// `slab_bytes`.  Thread 0 sets up the barriers; then the first `stages`
// groups start to flow, a warp each in turn, or the whole resident stream in
// copies of up to 16 KB, one a warp (each lane 0 its own), all completing on
// one barrier, which the kernel waits for before it reads (`ring.bars`,
// parity 0).  Contains a block barrier.  Returns the first byte past the ring.
template <int WGS, int G>
__device__ __forceinline__ unsigned char* ring_start(Ring& ring, const RingPlan& plan, unsigned char* smem,
                                                     const unsigned char* wsrc, int slab_bytes) {
    ring.slabs = smem_u32(smem);
    ring.bars = ring.slabs + plan.ring_slabs * slab_bytes;
    ring.wsrc = wsrc;
    ring.stages = plan.stages;
    ring.group = G;  // the entry checks the host planned with it
    ring.slab_bytes = slab_bytes;
    ring.n_warps = WGS * 4;
    ring.stage = ring.r = ring.r_stage = 0;
    ring.phase = ring.r_phase = 0;
    // warp w refills the stages of groups w, w + n_warps, ...; the warp's
    // index as a value the compiler knows is alike across the warp
    ring.turn_in = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);
    const int n_bars = plan.stages > 0 ? plan.stages : 1;
    const int tid = threadIdx.x, warp = tid >> 5;
    const int stream_bytes = plan.slabs * slab_bytes;
    constexpr int CHUNK = 16384;
    if (tid == 0) {
        for (int s = 0; s < n_bars; ++s) {
            mbar_init(ring.bars + 8 * s, 1);
            mbar_init(ring.bars + 8 * (n_bars + s), ring.n_warps);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        if (plan.stages == 0) mbar_expect_tx(ring.bars, static_cast<uint32_t>(stream_bytes));
    }
    __syncthreads();
    if ((tid & 31) == 0) {
        if (plan.stages > 0) {
            for (int s = warp; s < plan.stages; s += ring.n_warps) ring_copy(ring, plan, s, s, 0);
        } else {
            for (int off = warp * CHUNK; off < stream_bytes; off += ring.n_warps * CHUNK)
                bulk_copy(ring.slabs + off, wsrc + off, static_cast<uint32_t>(min(CHUNK, stream_bytes - off)),
                          ring.bars);
        }
    }
    return smem + static_cast<size_t>(plan.ring_slabs) * slab_bytes + 16 * n_bars;
}

// The shared address of step s of entry e's round: wait for its group where
// the ring streams (s is its first step), or find it in the resident stream.
__device__ __forceinline__ uint32_t ring_wait(Ring& ring, const RingPlan& plan, int e, int s) {
    if (ring.stages == 0) return ring.slabs + (plan.slab0[e] + s) * ring.slab_bytes;
    mbar_wait(full_bar(ring, ring.stage), ring.phase);
    const uint32_t addr = ring.slabs + ring.stage * ring.group * ring.slab_bytes;
    if (++ring.stage == ring.stages) {
        ring.stage = 0;
        ring.phase ^= 1u;
    }
    return addr;
}

// This warp is done with group r (of entry `e` or later): release it; the
// warp whose turn it is then refills its stage with group r + stages.
__device__ __forceinline__ void ring_release(Ring& ring, const RingPlan& plan, int e) {
    if (ring.stages == 0) return;
    const int lane = threadIdx.x & 31;
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar(ring, ring.r_stage));
    if (ring.turn_in == 0) {
        mbar_wait(empty_bar(ring, ring.r_stage), ring.r_phase);
        if (lane == 0) ring_copy(ring, plan, ring.r + ring.stages, ring.r_stage, e);
        __syncwarp();
    }
    ring.turn_in = (ring.turn_in == 0 ? ring.n_warps : ring.turn_in) - 1;
    ++ring.r;
    if (++ring.r_stage == ring.stages) {
        ring.r_stage = 0;
        ring.r_phase ^= 1u;
    }
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
