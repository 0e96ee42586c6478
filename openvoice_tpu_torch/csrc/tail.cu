// K4: a whole decoder stage with its upsample, in one launch.
//
// Replaces the TPU kernel openvoice_tpu/ops/mrf_pallas.py::fused_tail_stage
// (body _tail_kernel): leaky ReLU 0.1 -> ConvTranspose1d (kernel k_up, stride
// u, padding p with k_up = u + 2p, so T_out = T_in * u) -> mask -> the MRF
// stage of K3 (mrf_branch.cuh); on the last stage also leaky ReLU 0.01 ->
// conv_post (C -> 1, k_post taps, no bias) -> tanh, which gives the audio.
//
// The transposed convolution is y[t] = b + sum over (s, j) with s*u + j - p = t
// of x[s] @ W[j].  Output phase f = t mod u at output row m = t div u takes the
// taps j = j0 + i*u with j0 = (f + p) mod u, from input rows m + (f + p) div u
// - i.  So each phase is an ordinary row convolution of the input, whose
// results land on every u-th output row.
//
// Rounding points beyond mrf_branch.cuh's: the upsample's output is rounded to
// bf16 after its bias and before the mask; the MRF mean is rounded before the
// last leaky ReLU; tanh takes the f32 sum of conv_post.
//
// Masks: the input is masked at pos_in < len_out div u, everything after the
// upsample at 0 <= pos < len_out.
//
// What bounds it: operations (142 GFLOP at T_out=131072, 128 -> 64 channels;
// 72 GFLOP at T_out=262144, 64 -> 32), against 2 bytes a channel a sample
// in and out: over 1000 operations a byte.
//
// Design: one block per output time tile with a recomputed halo (the
// branches' 60 samples, plus conv_post's reach on the last stage).  The
// upsampled stage input cannot be read again from device memory, because it
// never exists there, so it gets a third shared-memory buffer; the staged
// input rows borrow the second conv's buffer, which is idle until the
// upsample has run; the finished branches' outputs wait in a scratch buffer
// in device memory for the last branch, as in K3.  The buffers are padded
// rows (LD_PAD), which ldmatrix reads without bank conflicts at every C.
// * Every product runs on Hopper's warpgroup MMA (wgmma.cuh, m64nNk16 with
//   N = C): a warpgroup computes one 64-row tile of a conv's output a round,
//   A, the shifted rows, from registers by ldmatrix (the first conv of a
//   pair applies its leaky ReLU to the fragments), B from shared memory.
//   The upsample's phases are convolutions over the staged input whose
//   64-row tiles are tiles of phase rows; every MRF conv covers the window
//   rows the convs after it in its branch still read (on the last stage the
//   kept rows reach conv_post's half width past the tile) with 64-row tiles
//   placed from the range's first row (the host's plan,
//   ops/tail_cuda.py::tail_tiles, as K3's ops/mrf_cuda.py::conv_tiles).
//   Rows outside a conv's tiles are not written and hold stale values that
//   only rows outside the next conv's range read; the rows a tile computes
//   past its range are made from such rows and are never read where it
//   matters.  The upsample fills every window row, since each branch starts
//   from the whole of it.
// * ptxas serialises every product of a warpgroup whose A registers are
//   written while one of its products runs, so a warpgroup loads the
//   fragments of up to PART slabs, issues their products back to back, and
//   waits for them (`products`).
// * The weights reach the tensor cores through shared memory: a slab is one
//   (tap, k-tile) of a conv, the [16, C] B tile, 32 * C bytes; the stage's
//   slabs are one stream in execution order (the upsample's phases, then the
//   MRF convs).  Where the whole stream fits beside the window (C = 16: 66
//   KB) it is loaded once a block by a few bulk copies from different warps.
//   Elsewhere it flows through a ring of groups of slabs, filled by 1-D bulk
//   copies that complete on mbarriers, as in K3: a copy moves a group, since
//   one thread's copies complete one after another.  The wrapper sizes the
//   group from C (16 KB: 8 slabs at C = 64, 16 at C = 32); a round whose
//   slabs are not a multiple of it ends on a shorter group, whose products
//   are issued in power-of-two parts.
// What holds it on an H100 (PERF.md): the four warpgroups issue their
// products nearly in step (they share the ring's groups and meet at a block
// barrier after every conv), so the tensor cores wait while all of them run
// their epilogues, barriers and the last round of a conv that leaves some of
// them without a tile; clock counters put a block's time at C = 64 at about
// a quarter products, a sixth epilogues, a tenth barriers and a tenth idle
// warpgroups.
// * A tile whose first sample (less conv_post's reach on the last stage)
//   lies at or past the length writes its zeros and returns before staging
//   anything; the length is read on the device, so the launch does not
//   depend on it.
// conv_post has one output channel, so it runs as scalar f32 sums over the
// rounded activations, one output sample a thread.

#include "bulk_copy.cuh"
#include "mrf_branch.cuh"
#include "wgmma.cuh"

using namespace ovt;

namespace {

constexpr int MAX_CONVS = MAX_BRANCHES * MAX_PAIRS * 2;
constexpr int MAX_PHASES = 8;                    // the upsample's stride at most
constexpr int MAX_SEQ = MAX_PHASES + MAX_CONVS;  // product sequence: the phases, then the MRF convs
constexpr int TILE_M = 64;                       // rows of one wgmma tile
constexpr int MAX_GROUP = 16;                    // slabs of one ring group
constexpr int PART = 8;                          // slabs whose products a warpgroup issues at once, at most
constexpr int MAX_STAGES = 32;                   // groups the ring holds at most
constexpr int SLAB_ALIGN = 256;                  // the 32-byte swizzle's period: slabs start on it

struct TailArgs {
    int t_in, cin, stride, k_up, pad_up, in_margin, k_post, rows, tile;
    int stages;      // ring groups; 0: the whole stream is resident
    int group;       // slabs a group
    int ring_slabs;  // slabs the ring's area holds
};

// The products of a block in execution order (entry e: the upsample's phase
// e for e < stride, else MRF conv e - stride) and their weight stream.  The
// host plans it (tail_stage_bf16).  A round is one tile a warpgroup; every
// warp walks every group of every round.
struct TailPlan {
    int first[MAX_SEQ];       // window (phase) row of the entry's first tile
    int count[MAX_SEQ];       // its 64-row tiles
    int steps[MAX_SEQ];       // slabs a round: taps x k-tiles
    int slab0[MAX_SEQ];       // its first slab in the stream
    int group_end[MAX_SEQ];   // ring groups of entries 0 .. e, every round
    int total;                // ring groups in all
};

// -- the weight ring -----------------------------------------------------------
//
// The ring moves the stream a group at a time: group p of entry e (each of
// the entry's rounds has ceil(steps / group) groups) is slabs [q * group,
// ...) of the entry's, q = p's index in its round, as one bulk copy into
// stage p % stages; its "full" barrier completes when the bytes land, its "empty"
// barrier when every warp has released it.  The warps take the refills in
// turn, as in K3's ring (mrf.cu): the warp whose turn it is waits until
// every warp has released the group and copies the next one into its stage,
// so that copies issued by different warps run at once and ahead of the
// reads across rounds, entries and block barriers.  (A release that lets the
// last warp to release refill at once, without waiting, measured slower on
// an H100: PERF.md.)  With stages == 0 the stream is resident and nothing is
// waited for or released.  K3's ring is not shared: this one ends a round on
// a shorter group, takes its plan from the host and has the resident mode,
// none of which K3 needs.

struct Ring {
    unsigned char* slabs;       // [stages][group slabs], or the whole stream
    uint64_t* full;             // [stages] (resident: [1])
    uint64_t* empty;            // [stages]
    const unsigned char* wsrc;  // the stream in device memory
    int stages, group, slab_bytes, n_warps;
    int stage;                  // the stage this warp reads next
    uint32_t phase;
    int r, r_stage;             // the group this warp releases next, and its stage
    uint32_t r_phase;
    int turn;                   // the warp that refills the stage of group r
};

// One thread: copy group p into `stage`.  `e` is an entry at or before p's.
__device__ __forceinline__ void ring_copy(const Ring& ring, const TailPlan& plan, int p, int stage, int e) {
    if (p >= plan.total) return;
    while (p >= plan.group_end[e]) ++e;
    const int start = e ? plan.group_end[e - 1] : 0;
    const int q = (p - start) % ((plan.steps[e] + ring.group - 1) / ring.group);  // its index in its round
    const int n = min(ring.group, plan.steps[e] - q * ring.group);
    const uint32_t bytes = static_cast<uint32_t>(n * ring.slab_bytes);
    mbar_expect_tx(ring.full + stage, bytes);
    bulk_copy(ring.slabs + static_cast<size_t>(stage) * ring.group * ring.slab_bytes,
              ring.wsrc + static_cast<size_t>(plan.slab0[e] + q * ring.group) * ring.slab_bytes, bytes,
              ring.full + stage);
}

// The shared address of step s of entry e's round: wait for its group where
// the ring streams (s is its first step), or find it in the resident stream.
__device__ __forceinline__ uint32_t ring_wait(Ring& ring, const TailPlan& plan, int e, int s) {
    if (ring.stages == 0) return smem_u32(ring.slabs + static_cast<size_t>(plan.slab0[e] + s) * ring.slab_bytes);
    mbar_wait(ring.full + ring.stage, ring.phase);
    const uint32_t addr = smem_u32(ring.slabs + static_cast<size_t>(ring.stage) * ring.group * ring.slab_bytes);
    if (++ring.stage == ring.stages) {
        ring.stage = 0;
        ring.phase ^= 1u;
    }
    return addr;
}

// This warp is done with group r (of entry `e` or later): release it; the
// warp whose turn it is then refills its stage with group r + stages.
__device__ __forceinline__ void ring_release(Ring& ring, const TailPlan& plan, int e) {
    if (ring.stages == 0) return;
    const int lane = threadIdx.x & 31;
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty + ring.r_stage);
    // the warp's index, as a value the compiler knows is alike across the warp
    if (__shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0) == ring.turn) {
        mbar_wait(ring.empty + ring.r_stage, ring.r_phase);
        if (lane == 0) ring_copy(ring, plan, ring.r + ring.stages, ring.r_stage, e);
        __syncwarp();
    }
    if (++ring.turn == ring.n_warps) ring.turn = 0;
    ++ring.r;
    if (++ring.r_stage == ring.stages) {
        ring.r_stage = 0;
        ring.r_phase ^= 1u;
    }
}

// P slabs' products of one warpgroup, back to back: acc += A rows @ slab
// for the next P steps (tap, k-tile) from (tap, kt), which advance.  Every
// fragment loads before the first product and the warpgroup waits for the
// last, as ptxas asks of A in registers.  A row of this lane at tap i is
// row_base + i * shift_step; rows outside [0, a_rows) read `zero_row`.
template <int N, int P, bool LRELU>
__device__ __forceinline__ void products(float (&acc)[N / 2], const bf16* a, int lda, int a_rows, int row_base,
                                         int shift_step, const bf16* zero_row, int lcol, int k_tiles, int& tap,
                                         int& kt, uint32_t slab, bf162 slope) {
    uint32_t af[P][4];
#pragma unroll
    for (int q = 0; q < P; ++q) {
        const int row = row_base + tap * shift_step;
        const bf16* arow = (row >= 0 && row < a_rows) ? a + static_cast<size_t>(row) * lda : zero_row;
        ldmatrix_x4(af[q], arow + kt * 16 + lcol);
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
    for (int q = 0; q < P; ++q) Wgmma<N>::mma(acc, af[q], b_desc(slab + q * 32 * N));
    wgmma_commit();
    wgmma_wait<0>();
}

// Entry e of the plan as a block-wide convolution over its tiles:
//   y[r, n] = bias[n] + sum_i A[r + shift0 + i * shift_step, :] @ W_i[:, n]
// with k_tiles k-tiles a tap, its slabs from the ring.  Warpgroup w takes
// tile w of each round of WGS; a warpgroup without a tile walks the ring
// alone.  A group's products go in parts of PART slabs, then of powers of
// two.  Each element pair (r, n), (r, n + 1) goes once through
// store(r, n, y0, y1).  No block barrier inside.
template <int N, int WGS, bool LRELU, typename Store>
__device__ __forceinline__ void conv_wgmma(const bf16* a, int lda, int a_rows, int k_tiles, const bf16* zero_row,
                                           int shift0, int shift_step, const bf16* bias, bf162 slope, Ring& ring,
                                           const TailPlan& plan, int e, Store store) {
    // the warpgroup, as a value the compiler knows is alike across the warp
    const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
    const int lane = threadIdx.x & 31;
    const int wrow = ((threadIdx.x >> 5) & 3) * 16;  // this warp's 16 rows of the tile
    const int lcol = (lane >> 4) * 8;
    const int first = plan.first[e], count = plan.count[e], steps = plan.steps[e];
    for (int round0 = 0; round0 < count; round0 += WGS) {
        const int item = round0 + wg;
        if (item >= count) {
            for (int s = 0; s < steps; s += ring.group) {
                ring_wait(ring, plan, e, s);
                ring_release(ring, plan, e);
            }
            continue;
        }
        const int row0 = first + item * TILE_M;
        const int row_base = row0 + wrow + (lane & 15) + shift0;  // this lane's A row at tap 0
        float acc[N / 2];
#pragma unroll
        for (int q = 0; q < N / 2; ++q) acc[q] = 0.f;
        int tap = 0, kt = 0;
        for (int s = 0; s < steps; s += ring.group) {
            int left = min(ring.group, steps - s);
            uint32_t slab = ring_wait(ring, plan, e, s);
            for (; left >= PART; left -= PART, slab += PART * 32 * N)
                products<N, PART, LRELU>(acc, a, lda, a_rows, row_base, shift_step, zero_row, lcol, k_tiles, tap,
                                         kt, slab, slope);
            if (left & 4) {
                products<N, 4, LRELU>(acc, a, lda, a_rows, row_base, shift_step, zero_row, lcol, k_tiles, tap, kt,
                                      slab, slope);
                slab += 4 * 32 * N;
            }
            if (left & 2) {
                products<N, 2, LRELU>(acc, a, lda, a_rows, row_base, shift_step, zero_row, lcol, k_tiles, tap, kt,
                                      slab, slope);
                slab += 2 * 32 * N;
            }
            if (left & 1)
                products<N, 1, LRELU>(acc, a, lda, a_rows, row_base, shift_step, zero_row, lcol, k_tiles, tap, kt,
                                      slab, slope);
            ring_release(ring, plan, e);
        }
        fence_acc(acc);
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
            const int col = j * 8 + (lane & 3) * 2;
            const float2 bc = __bfloat1622float2(*reinterpret_cast<const bf162*>(bias + col));
#pragma unroll
            for (int half = 0; half < 2; ++half)
                store(row0 + wrow + (lane >> 2) + half * 8, col, acc[4 * j + 2 * half] + bc.x,
                      acc[4 * j + 2 * half + 1] + bc.y);
        }
    }
}

// The branch chains of mrf_branch.cuh on the window, MRF conv cv as plan
// entry e0 + cv; bias [n_convs][C] in shared memory.  load_x0() fills w.xb
// with the masked stage input (every thread calls it; no barrier needed
// inside).  result(row, col, m0, m1) receives the stage's result for rows
// acc_row0 .. acc_row0 + acc_rows, once per element pair.  Ends with a
// barrier.
template <int N, int WGS, typename LoadX0, typename Result>
__device__ __forceinline__ void tail_branches(const MrfWindow& w, const MrfMeta& meta, const TailPlan& plan, int e0,
                                              Ring& ring, const bf16* bias, LoadX0 load_x0, Result result) {
    constexpr int c = N;
    const float slope_f = __bfloat162float(__float2bfloat16_rn(0.1f));
    const bf162 slope = __float2bfloat162_rn(0.1f);
    const float n_br = static_cast<float>(meta.n_branches);
    auto live = [&](int row) { const int p = w.pos0 + row; return p >= 0 && p < w.length; };
    int cv = 0;

    for (int br = 0; br < meta.n_branches; ++br) {
        load_x0();
        __syncthreads();
        const int k = meta.ksize[br], half = (k - 1) / 2;
        for (int pair = 0; pair < meta.n_pairs; ++pair, cv += 2) {
            const int d = meta.dilation[br][pair];
            conv_wgmma<N, WGS, true>(w.xb, w.ld, w.rows, c / 16, w.zero_row, -half * d, d, bias, slope, ring, plan,
                                     e0 + cv, [&](int row, int col, float v0, float v1) {
                                         const bool ok = live(row);
                                         const float a0 = ok ? lrelu_bf16(round_bf16(v0), slope_f) : 0.f;
                                         const float a1 = ok ? lrelu_bf16(round_bf16(v1), slope_f) : 0.f;
                                         *reinterpret_cast<bf162*>(w.xt + static_cast<size_t>(row) * w.ld + col) =
                                             __floats2bfloat162_rn(a0, a1);
                                     });
            bias += c;
            __syncthreads();
            const bool last_pair = pair == meta.n_pairs - 1;
            conv_wgmma<N, WGS, false>(
                w.xt, w.ld, w.rows, c / 16, w.zero_row, -half, 1, bias, slope, ring, plan, e0 + cv + 1,
                [&](int row, int col, float v0, float v1) {
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

// Shared memory of one block, in bytes: room to align the slabs, the ring's
// (or the resident stream's) slabs and their barriers, a row of zeros, the
// window's three buffers (the third also holds the staged input) and the
// biases of the upsample and the n_convs MRF convs; 16-byte aligned
// throughout, as the bulk copies and ldmatrix ask.
__host__ __device__ __forceinline__ int smem_bytes(int cin, int chan, int stride, int in_margin, int rows,
                                                   int n_convs, int ring_slabs, int stages) {
    const int ld = chan + LD_PAD, ldin = cin + LD_PAD;
    const int in_rows = rows / stride + 2 * in_margin;
    const long long xt = (long long)rows * ld > (long long)in_rows * ldin ? (long long)rows * ld
                                                                            : (long long)in_rows * ldin;
    const long long bytes = SLAB_ALIGN + (long long)ring_slabs * 32 * chan + 16LL * (stages > 0 ? stages : 1) +
                            2LL * ((ld > ldin ? ld : ldin) + 2LL * rows * ld + xt + (1LL + n_convs) * chan);
    return bytes > 0x7fffffff ? 0x7fffffff : static_cast<int>(bytes);
}

template <int N, int WGS>
__global__ void __launch_bounds__(WGS * 128, 1)
tail_stage_kernel(const bf16* __restrict__ x, const int* __restrict__ lengths,
                  const unsigned char* __restrict__ wslabs, const bf16* __restrict__ up_bias,
                  const bf16* __restrict__ bias, const bf16* __restrict__ post_w, bf16* __restrict__ out,
                  bf16* __restrict__ scratch, TailArgs a, MrfMeta meta, TailPlan plan) {
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    constexpr int chan = N;
    const int cin = a.cin, rows = a.rows, tile = a.tile, u = a.stride;
    const bool is_last = post_w != nullptr;
    const int post_half = is_last ? (a.k_post - 1) / 2 : 0;
    const int b = blockIdx.y;
    const int t_out = a.t_in * u;
    const int t0 = blockIdx.x * tile;
    const int len_out = min(lengths[b], t_out);
    const int tid = threadIdx.x, n_threads = blockDim.x;
    const int vec = chan / 8;
    bf16* orow = out + static_cast<size_t>(b) * t_out * chan;  // middle stage: [B, T_out, C]

    if (t0 - post_half >= len_out) {
        // every sample of the tile lies past the length (on the last stage,
        // past conv_post's reach beyond it too): its output is exactly 0
        const int end = min(t0 + tile, t_out);
        if (is_last) {
            for (int pos = t0 + tid; pos < end; pos += n_threads)
                out[static_cast<size_t>(b) * t_out + pos] = __float2bfloat16_rn(0.f);
        } else {
            for (int i = tid; i < (end - t0) * vec; i += n_threads)
                *reinterpret_cast<uint4*>(orow + static_cast<size_t>(t0) * chan + static_cast<size_t>(i) * 8) =
                    make_uint4(0u, 0u, 0u, 0u);
        }
        return;  // the whole block leaves; no barrier follows
    }

    unsigned char* smem = smem_raw + (SLAB_ALIGN - smem_u32(smem_raw) % SLAB_ALIGN) % SLAB_ALIGN;
    Ring ring;
    ring.slabs = smem;
    ring.wsrc = wslabs;
    ring.stages = a.stages;
    ring.group = a.group;
    ring.slab_bytes = 32 * chan;
    ring.n_warps = WGS * 4;
    ring.stage = ring.r = ring.r_stage = ring.turn = 0;
    ring.phase = ring.r_phase = 0;
    const int n_bars = a.stages > 0 ? a.stages : 1;
    ring.full = reinterpret_cast<uint64_t*>(smem + static_cast<size_t>(a.ring_slabs) * ring.slab_bytes);
    ring.empty = ring.full + n_bars;

    const int ld = chan + LD_PAD, ldin = cin + LD_PAD;
    const int in_rows = rows / u + 2 * a.in_margin;
    const int ldz = max(ld, ldin);
    bf16* zero_row = reinterpret_cast<bf16*>(ring.full + 2 * n_bars);
    bf16* x0 = zero_row + ldz;
    bf16* xb = x0 + static_cast<size_t>(rows) * ld;
    bf16* xt = xb + static_cast<size_t>(rows) * ld;
    bf16* xin = xt;  // the staged input borrows xt until the upsample is done
    const int n_convs = 2 * meta.n_branches * meta.n_pairs;
    // the biases, read in every epilogue: the upsample's, then each conv's
    bf16* sbias = xt + (rows * ld > in_rows * ldin ? static_cast<size_t>(rows) * ld
                                                   : static_cast<size_t>(in_rows) * ldin);

    // the weights start to flow before anything else: the ring's first
    // groups, or the whole resident stream in copies of up to 16 KB, one a
    // warp (each lane 0 its own), all completing on one barrier
    const int warp = tid >> 5, lane = tid & 31;
    const int stream_bytes = plan.slab0[u + n_convs - 1] * ring.slab_bytes + plan.steps[u + n_convs - 1] *
                                                                                 ring.slab_bytes;
    constexpr int CHUNK = 16384;
    if (tid == 0) {
        for (int s = 0; s < n_bars; ++s) {
            mbar_init(ring.full + s, 1);
            mbar_init(ring.empty + s, ring.n_warps);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        if (a.stages == 0) mbar_expect_tx(ring.full, static_cast<uint32_t>(stream_bytes));
    }
    __syncthreads();
    if (lane == 0) {
        if (a.stages > 0) {
            for (int s = warp; s < a.stages; s += ring.n_warps) ring_copy(ring, plan, s, s, 0);
        } else {
            for (int off = warp * CHUNK; off < stream_bytes; off += ring.n_warps * CHUNK)
                bulk_copy(ring.slabs + off, wslabs + off, static_cast<uint32_t>(min(CHUNK, stream_bytes - off)),
                          ring.full);
        }
    }

    bf16* parked = scratch + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * (meta.n_branches - 1) *
                                 (tile + 2 * post_half) * chan;
    const int halo = (rows - tile) / 2;
    const int pos0 = t0 - halo;          // a multiple of u: tile and halo are
    const int m0 = pos0 / u;             // exact, also when negative
    const int len_in = len_out / u;
    const float slope_f = __bfloat162float(__float2bfloat16_rn(0.1f));

    for (int i = tid; i < ldz; i += n_threads) zero_row[i] = __float2bfloat16_rn(0.f);
    for (int i = tid; i < (1 + n_convs) * chan; i += n_threads) sbias[i] = i < chan ? up_bias[i] : bias[i - chan];
    // staged input row i is input sample m0 - in_margin + i, activated and
    // masked, 8 channels a thread at a time
    {
        const bf16* xrow = x + static_cast<size_t>(b) * a.t_in * cin;
        const int vin = cin / 8;
        for (int i = tid; i < in_rows * vin; i += n_threads) {
            const int row = i / vin, c = (i % vin) * 8;
            const int m = m0 - a.in_margin + row;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (m >= 0 && m < len_in) {
                v = *reinterpret_cast<const uint4*>(xrow + static_cast<size_t>(m) * cin + c);
                bf162* h = reinterpret_cast<bf162*>(&v);
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const float2 f = __bfloat1622float2(h[q]);
                    h[q] = __floats2bfloat162_rn(lrelu_bf16(f.x, slope_f), lrelu_bf16(f.y, slope_f));
                }
            }
            *reinterpret_cast<uint4*>(xin + static_cast<size_t>(row) * ldin + c) = v;
        }
    }
    if (a.stages == 0) mbar_wait(ring.full, 0);
    __syncthreads();

    auto live = [&](int row) { const int p = pos0 + row; return p >= 0 && p < len_out; };
    // upsample, one output phase at a time, on every window row: phase row m
    // is window row m * u + f
    const int phase_rows = rows / u;
    for (int f = 0; f < u; ++f) {
        const int ds0 = (f + a.pad_up) / u;
        conv_wgmma<N, WGS, false>(xin, ldin, in_rows, cin / 16, zero_row, a.in_margin + ds0, -1, sbias, no_slope(),
                                  ring, plan, f, [&](int m, int col, float v0, float v1) {
                                      if (m >= phase_rows) return;
                                      const int orow_ = m * u + f;
                                      const bool ok = live(orow_);
                                      *reinterpret_cast<bf162*>(x0 + static_cast<size_t>(orow_) * ld + col) =
                                          __floats2bfloat162_rn(ok ? v0 : 0.f, ok ? v1 : 0.f);
                                  });
    }
    __syncthreads();

    MrfWindow w;
    w.xb = xb; w.xt = xt; w.parked = parked; w.zero_row = zero_row;
    w.rows = rows; w.ld = ld; w.chan = chan;
    w.acc_row0 = halo - post_half; w.acc_rows = tile + 2 * post_half;
    w.pos0 = pos0; w.length = len_out;

    const float slope_post = __bfloat162float(__float2bfloat16_rn(0.01f));
    tail_branches<N, WGS>(
        w, meta, plan, u, ring, sbias + chan,
        [&]() {
            for (int i = tid; i < rows * vec; i += n_threads) {
                const size_t off = static_cast<size_t>(i / vec) * ld + (i % vec) * 8;
                *reinterpret_cast<uint4*>(xb + off) = *reinterpret_cast<const uint4*>(x0 + off);
            }
        },
        [&](int row, int col, float m0_, float m1_) {
            if (is_last) {
                // the last branch has copied x0 away: it now holds the
                // activated mean that conv_post reads, on the rows
                // acc_row0 .. acc_row0 + acc_rows and no others
                *reinterpret_cast<bf162*>(x0 + static_cast<size_t>(row) * ld + col) =
                    __floats2bfloat162_rn(lrelu_bf16(round_bf16(m0_), slope_post),
                                          lrelu_bf16(round_bf16(m1_), slope_post));
            } else {
                const int pos = pos0 + row;
                if (pos < t_out)
                    *reinterpret_cast<bf162*>(orow + static_cast<size_t>(pos) * chan + col) =
                        __floats2bfloat162_rn(m0_, m1_);
            }
        });
    if (!is_last) return;

    // conv_post and tanh: audio[t] = tanh(sum_j ym[t + j - half] . w[j])
    for (int r = tid; r < tile; r += n_threads) {
        const int pos = t0 + r;
        if (pos >= t_out) break;
        float sum = 0.f;
        for (int j = 0; j < a.k_post; ++j) {
            const bf16* yr = x0 + static_cast<size_t>(halo + r + j - post_half) * ld;
            const bf16* wj = post_w + j * chan;
            for (int c = 0; c < chan; c += 2) {
                const float2 y = __bfloat1622float2(*reinterpret_cast<const bf162*>(yr + c));
                const float2 ww = __bfloat1622float2(*reinterpret_cast<const bf162*>(wj + c));
                sum = fmaf(y.x, ww.x, sum);
                sum = fmaf(y.y, ww.y, sum);
            }
        }
        out[static_cast<size_t>(b) * t_out + pos] = __float2bfloat16_rn(tanhf(sum));
    }
}

// The kernel instance of a channel count and warpgroup count, or null.
typedef void (*KernelFn)(const bf16*, const int*, const unsigned char*, const bf16*, const bf16*, const bf16*,
                         bf16*, bf16*, TailArgs, MrfMeta, TailPlan);

KernelFn kernel_for(int chan, int warpgroups) {
    switch (chan * 8 + warpgroups) {
        case 16 * 8 + 3: return tail_stage_kernel<16, 3>;
        case 16 * 8 + 4: return tail_stage_kernel<16, 4>;
        case 32 * 8 + 3: return tail_stage_kernel<32, 3>;
        case 32 * 8 + 4: return tail_stage_kernel<32, 4>;
        case 64 * 8 + 3: return tail_stage_kernel<64, 3>;
        case 64 * 8 + 4: return tail_stage_kernel<64, 4>;
        default: return nullptr;
    }
}

}  // namespace

// Shared memory of one block, in bytes (smem_bytes above): ring_slabs slabs
// of 32 * chan bytes in `stages` groups, or the whole resident stream with
// stages = 0.
extern "C" int tail_stage_smem_bytes(int cin, int chan, int stride, int in_margin, int rows, int n_convs,
                                     int ring_slabs, int stages) {
    return smem_bytes(cin, chan, stride, in_margin, rows, n_convs, ring_slabs, stages);
}

// What the kernel instance of a channel count and warpgroup count takes on
// the card: out[0] registers a thread, out[1] local memory a thread in bytes
// (spills), out[2] how many blocks of its threads and `smem` bytes an SM
// holds at once.  Returns the CUDA error (0 on success), -1 for an instance
// that does not exist.
extern "C" int tail_stage_attributes(int chan, int warpgroups, int smem, int device, int* out) {
    const KernelFn fn = kernel_for(chan, warpgroups);
    if (fn == nullptr) return -1;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, fn, warpgroups * 128, smem));
}

// x [batch, t_in, cin] bf16; lengths [batch] int32 true OUTPUT sample counts;
// wslabs: the stage's weight stream, slabs of wgmma.cuh's B layout (32 * chan
// bytes each) in execution order: for each upsample phase f, its taps j =
// (f + pad_up) mod stride + i * stride (i = 0, 1, ...), each [cin/16]
// slabs of the transposed convolution's W[:, :, j]; then every MRF tap as
// mrf_stage_bf16's, [chan/16] slabs each (ops/tail_cuda.py::pack_stream);
// up_bias [chan]; bias [n_convs][chan]; ksizes [n_branches]; dilations
// [n_branches][n_pairs]; tiles [n_convs][2]: each MRF conv's first window
// row and its nonzero count of 64-row tiles, inside [0, rows); post_w
// [k_post][chan] bf16 or null; scratch: batch * ceil(t_out / tile) *
// (n_branches - 1) * (tile + k_post - 1) * chan bf16 (tile rows a block
// without post_w).  out is [batch, t_in * stride, chan] bf16 for a middle
// stage and [batch, t_in * stride] bf16 audio when post_w is given.
// chan is 16, 32 or 64; cin % 16 == 0; stride up to 8; rows % 64 == 0 and
// rows % stride == 0; the halo (rows - tile) / 2 and tile are multiples of
// stride.  stages: the ring's groups of `group` slabs (1 to 16), up to 32,
// or 0 for a resident stream (every slab in shared memory, a copy per 16
// KB); warpgroups: 3 or 4.  Returns the CUDA error of the launch (0 on
// success), -1 for too many branches, pairs or phases, a bad tile range,
// ring or instance.
extern "C" int tail_stage_bf16(const void* x, const int* lengths, const void* wslabs, const void* up_bias,
                               const void* bias, const void* post_w, void* out, void* scratch, int batch, int t_in,
                               int cin, int chan, int stride, int k_up, int pad_up, int in_margin, int k_post,
                               int n_branches, int n_pairs, const int* ksizes, const int* dilations,
                               const int* tiles, int rows, int tile, int stages, int group, int warpgroups,
                               int device, void* stream) {
    if (n_branches < 1 || n_branches > MAX_BRANCHES || n_pairs < 1 || n_pairs > MAX_PAIRS) return -1;
    if (stride < 1 || stride > MAX_PHASES || cin % 16 || rows % TILE_M || rows % stride || stages < 0 ||
        stages > MAX_STAGES || group < 1 || group > MAX_GROUP)
        return -1;
    const KernelFn fn = kernel_for(chan, warpgroups);
    if (fn == nullptr) return -1;
    const int n_convs = 2 * n_branches * n_pairs;
    // the plan: the upsample's phases over every phase row, then the MRF
    // convs on their tiles; the stream's slabs and the ring's groups
    TailPlan plan;
    int slabs = 0, groups = 0;
    for (int e = 0; e < stride + n_convs; ++e) {
        int steps;
        if (e < stride) {
            const int j0 = (e + pad_up) % stride;
            steps = (k_up - j0 + stride - 1) / stride * (cin / 16);
            plan.first[e] = 0;
            plan.count[e] = (rows / stride + TILE_M - 1) / TILE_M;
        } else {
            const int cv = e - stride;
            steps = ksizes[cv / (2 * n_pairs)] * (chan / 16);
            plan.first[e] = tiles[2 * cv];
            plan.count[e] = tiles[2 * cv + 1];
            if (plan.first[e] < 0 || plan.count[e] < 1 || plan.first[e] + plan.count[e] * TILE_M > rows) return -1;
        }
        if (steps < 1) return -1;
        plan.steps[e] = steps;
        plan.slab0[e] = slabs;
        slabs += steps;
        groups += (plan.count[e] + warpgroups - 1) / warpgroups * ((steps + group - 1) / group);
        plan.group_end[e] = groups;
    }
    plan.total = groups;
    const int ring_slabs = stages > 0 ? stages * group : slabs;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int smem = smem_bytes(cin, chan, stride, in_margin, rows, n_convs, ring_slabs, stages);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    TailArgs a;
    a.t_in = t_in; a.cin = cin; a.stride = stride; a.k_up = k_up; a.pad_up = pad_up;
    a.in_margin = in_margin; a.k_post = k_post; a.rows = rows; a.tile = tile;
    a.stages = stages; a.group = group; a.ring_slabs = ring_slabs;
    const int t_out = t_in * stride;
    const dim3 grid((t_out + tile - 1) / tile, batch);
    fn<<<grid, warpgroups * 128, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), lengths, static_cast<const unsigned char*>(wslabs),
        static_cast<const bf16*>(up_bias), static_cast<const bf16*>(bias), static_cast<const bf16*>(post_w),
        static_cast<bf16*>(out), static_cast<bf16*>(scratch), a, make_meta(n_branches, n_pairs, ksizes, dilations),
        plan);
    return static_cast<int>(cudaGetLastError());
}
