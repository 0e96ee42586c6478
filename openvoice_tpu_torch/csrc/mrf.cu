// K3: one HiFi-GAN multi-receptive-field stage in one launch.
//
// Replaces the TPU kernel openvoice_tpu/ops/mrf_pallas.py::fused_mrf_stage
// (body _mrf_kernel): the mean of the stage's ResBlock1 branches (kernel
// sizes 3/7/11, dilations 1/3/5: 18 convs of [C, C] taps, leaky ReLU 0.1, a
// mask rebuilt from the true sample length before every conv, bias, residual
// adds), with the activation read once and written once.  Rounding points:
// mrf_branch.cuh.
//
// What bounds it: 2*T*126*C*C operations (135 GFLOP at T=8192, C=256; 271
// GFLOP at T=65536, C=128) against 2*T*C*2 bytes of activation and 126*C*C*2
// bytes of weights, more than 3000 operations a byte, so operations bound it.
//
// Design: one block per time tile.  Its window (tile + a 60-sample halo a
// side at the V2 branches) lives in shared memory as two bf16 buffers, the
// running residual and the second conv's operand, each row's 16-byte chunks
// XOR-swizzled by the row (`at`), so that ldmatrix's eight rows fall on
// different banks without padding.  The halo is recomputed by both
// neighbours, but each conv computes only the rows that the convs after it
// in its branch still read: conv j of a branch is needed on the kept tile
// widened by the reaches of the convs after it (ops/mrf_cuda.py::conv_ranges),
// covered by 64-row tiles placed from the range's first row
// (ops/mrf_cuda.py::conv_tiles), so the shallow branches and the late convs
// of the deep one skip most of the halo.  The last tile of a range may reach
// past it; those rows, like every row outside a range, hold stale values,
// which only rows outside the next conv's range read, and never reach the
// kept rows.  The stage input is read again from device memory (L2) at the
// start of each branch instead of being kept in a third buffer, and the
// finished branches' outputs wait in a scratch buffer in device memory until
// the last branch sums them (each thread reads back only what it wrote
// itself, so no barrier guards it).
//
// Products run on Hopper's warpgroup MMA (wgmma.cuh): each warpgroup
// computes one 64-row x N-column tile a round (N = C, or C split in N-wide
// parts), one m64nNk16 per tap and k-tile, with A, the shifted activation
// rows, from registers (ldmatrix takes a row address a lane, so a tap's
// shift and dilation need no 8-row alignment, and the leaky ReLU of the
// first conv of a pair is applied to the fragments) and B from the weight
// ring below.  ptxas serializes every product of a warpgroup whose A
// registers are written while one of its products runs, so a warpgroup
// loads the fragments of a group of slabs, issues their products back to
// back and waits for them (`conv_wgmma`); the warpgroups overlap one
// another's loads and products, not their own.  A group is released once
// the products that read it have completed.
//
// The weights reach the tensor cores through a ring of slab groups in shared
// memory, filled by 1-D bulk async copies that complete on mbarriers: a
// block reads each conv's weights from L2 once a round, and a product waits
// on shared memory, not on L2.
//
// What holds it on an H100 (PERF.md): at C = 256 the window (192
// rows, 72 kept) computes 2.19x the useful products with its 64-row tiles
// (1.87x at the former 16-row grain, 2.67x with tiles at 64-row boundaries);
// at C = 128 (384 rows, 264 kept) 1.32x.  Shared memory leaves the ring 4
// slabs at C = 256 (two groups), 8 at C = 128.  One block takes as long as
// the whole grid, and of its time the tensor cores are busy a little over a
// third: each warpgroup's own loads, waits and releases between its groups,
// the ring (a group's refill waits for the slowest warpgroup's release of
// it), and the epilogues and block barriers between convs, during which no
// product runs.  PERF.md keeps the ablations that weigh these.

#include "bulk_copy.cuh"
#include "mrf_branch.cuh"
#include "wgmma.cuh"

using namespace ovt;

namespace {

constexpr int MAX_CONVS = MAX_BRANCHES * MAX_PAIRS * 2;
constexpr int TILE_M = 64;        // rows of one wgmma tile
constexpr int MAX_STAGES = 16;    // slabs the weight ring holds at most
constexpr int SLAB_ALIGN = 256;   // the 32-byte swizzle's period: slabs start on it

// The window rows each conv computes, in execution order: `count` 64-row
// tiles from row `first`.
struct ConvTiles {
    int first[MAX_CONVS], count[MAX_CONVS];
};

// Element (row, col) of a window buffer (mrf_branch.cuh's MrfWindow, here
// with ld = chan): the 16-byte chunk col / 8 of a row lies at chunk
// (col / 8) ^ (row % 8) (chan is a multiple of 64).
__device__ __forceinline__ int at(int row, int col, int chan) {
    return row * chan + ((((col >> 3) ^ row) & 7) | ((col >> 3) & ~7)) * 8 + (col & 7);
}

// -- the weight ring -----------------------------------------------------------
//
// A slab is the packed weights of one (tap, k-tile): the [16, C] B tile of
// wgmma.cuh, 32 * C bytes, and a conv's slabs are consecutive.  Every warp
// walks the same sequence of slabs: for each conv, for each round of one item
// a warpgroup, for each tap and k-tile, one slab.  The ring moves them G at a
// time (G = group_steps: the slabs a warpgroup's products take at once), as
// one bulk copy of G consecutive slabs into a stage of G slabs: a group g
// lives in stage g % stages; its "full" barrier completes when its bytes
// land, its "empty" barrier when every warp has released it (a warp with no
// item in the round releases it all the same).  A warp releases a group once
// its own products on it have completed; the warp whose turn it is then
// waits until every warp has released it and copies group g + stages into
// its stage: the warps take the copies in turn, so that copies issued by
// different warps run at once (one thread's bulk copies complete one after
// another, about 450 cycles apart on an H100), and the copies run ahead of
// the reads across rounds, convs and the block's barriers.  A group's
// source follows from its index through a small plan in shared memory.

struct RingPlan {
    int group_end[MAX_CONVS];     // groups of convs 0 .. cv, every round
    int round_groups[MAX_CONVS];  // groups of one round of conv cv: taps x k-tiles / G
    int first_group[MAX_CONVS];   // conv cv's weights start at this group
    int total;
};

struct WeightRing {
    unsigned char* slabs;        // [stages][group_bytes] in shared memory; the barriers and the plan follow
    const unsigned char* wsrc;   // every conv's slabs, in execution order
    int stages, group_bytes, n_warps;
    int g, stage;                // the group this warp reads next, and its stage
    uint32_t phase;              // (g / stages) & 1
    int r, r_stage;              // the group this warp releases next, and its stage
    uint32_t r_phase;            // (r / stages) & 1
    int turn;                    // the warp that refills the stage of group r
    __device__ uint64_t* full() const { return reinterpret_cast<uint64_t*>(slabs + stages * group_bytes); }
    __device__ uint64_t* empty() const { return full() + stages; }
    __device__ const RingPlan& plan() const { return *reinterpret_cast<const RingPlan*>(empty() + stages); }
};

// Shared memory of a ring of `slabs` slabs (a multiple of the group): the
// slabs, two barriers a slab (at most one a group is used) and the plan.
__host__ __device__ __forceinline__ int ring_bytes(int chan, int slabs) {
    const int plan = (static_cast<int>(sizeof(RingPlan)) + 15) / 16 * 16;
    return slabs * (32 * chan + 2 * static_cast<int>(sizeof(uint64_t))) + plan;
}

// One thread: copy group p into `stage`.  `cv` is a conv at or before p's.
__device__ __forceinline__ void ring_copy(const WeightRing& ring, int p, int stage, int cv) {
    const RingPlan& plan = ring.plan();
    if (p >= plan.total) return;
    while (p >= plan.group_end[cv]) ++cv;
    const int start = cv ? plan.group_end[cv - 1] : 0;
    const int group = plan.first_group[cv] + (p - start) % plan.round_groups[cv];
    const uint32_t bytes = static_cast<uint32_t>(ring.group_bytes);
    mbar_expect_tx(ring.full() + stage, bytes);
    bulk_copy(ring.slabs + static_cast<size_t>(stage) * ring.group_bytes,
              ring.wsrc + static_cast<size_t>(group) * ring.group_bytes, bytes, ring.full() + stage);
}

// Wait until the group this warp reads next has landed; returns the shared
// address of its first slab.
__device__ __forceinline__ uint32_t ring_wait(WeightRing& ring) {
    mbar_wait(ring.full() + ring.stage, ring.phase);
    const uint32_t slab = smem_u32(ring.slabs + static_cast<size_t>(ring.stage) * ring.group_bytes);
    ++ring.g;
    if (++ring.stage == ring.stages) {
        ring.stage = 0;
        ring.phase ^= 1u;
    }
    return slab;
}

// This warp is done with group r (of conv `cv` or later): release it; the
// warp whose turn it is then refills its stage with group r + stages.
__device__ __forceinline__ void ring_release(WeightRing& ring, int cv) {
    const int lane = threadIdx.x & 31;
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty() + ring.r_stage);
    // the warp's index, as a value the compiler knows is alike across the warp
    if (__shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0) == ring.turn) {
        mbar_wait(ring.empty() + ring.r_stage, ring.r_phase);
        if (lane == 0) ring_copy(ring, ring.r + ring.stages, ring.r_stage, cv);
        __syncwarp();
    }
    if (++ring.turn == ring.n_warps) ring.turn = 0;
    ++ring.r;
    if (++ring.r_stage == ring.stages) {
        ring.r_stage = 0;
        ring.r_phase ^= 1u;
    }
}

// Slabs whose products a warpgroup issues at once (G), and that the ring
// moves in one copy: their fragments load before the products start, as
// ptxas asks of A in registers (a fragment defined while a product of the
// same warpgroup runs serializes them all).  Two at N = 256, whose 128
// accumulators a thread leave room for two slabs' fragments, four below.
__host__ __device__ constexpr int group_steps(int n) { return n >= 256 ? 2 : 4; }

// One conv over `count` 64-row tiles from window row `first`, its weights
// streamed through the ring:
//   y[r, n] = bias[n] + sum_i A[r + shift0 + i * shift_step, :] @ W[i][:, n]
// A is a window buffer (rows outside [0, rows) read `zero_row`).  An item is
// one tile's N-column part; warpgroup w takes item w of each round of WGS.
// Each element pair goes once through store(r, n, y0, y1).  No block
// barrier inside.
//
// A warpgroup with an item loads the fragments of a group of G slabs,
// issues their G products back to back, waits for them and releases the
// group; while it loads, the other warpgroups' products keep the tensor
// cores busy.  Its waits are unconditional on its own path, so ptxas proves
// every fragment rewrite and accumulator read ordered after the products
// that used them.  A warpgroup without an item walks the ring alone.
template <int N, int WGS, bool LRELU, typename Store>
__device__ __forceinline__ void conv_wgmma(const bf16* a, int rows, int first, int count, int chan,
                                           const bf16* zero_row, int n_taps, int shift0, int shift_step,
                                           const bf16* __restrict__ bias, bf162 slope, WeightRing& ring, int cv,
                                           Store store) {
    constexpr int G = group_steps(N);
    // the warpgroup, as a value the compiler knows is alike across the warp
    const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
    const int lane = threadIdx.x & 31;
    const int wrow = ((threadIdx.x >> 5) & 3) * 16;  // this warp's 16 rows of the tile
    const int k_tiles = chan >> 4, n_items = count * (chan / N), steps = n_taps * k_tiles;
    const int lchunk = lane >> 4;
    const uint32_t slab_bytes = 32u * chan;
    for (int round0 = 0; round0 < n_items; round0 += WGS) {
        const int item = round0 + wg;
        if (item >= n_items) {
            for (int s = 0; s < steps; s += G) {
                ring_wait(ring);
                ring_release(ring, cv);
            }
            continue;
        }
        const int part = item / count;
        const int row0 = first + (item % count) * TILE_M;
        const int row_base = row0 + wrow + (lane & 15) + shift0;  // this lane's A row at tap 0
        const uint32_t b_off = static_cast<uint32_t>(part) * N * 32;
        float acc[N / 2];
#pragma unroll
        for (int q = 0; q < N / 2; ++q) acc[q] = 0.f;
        int tap = 0, kt = 0;
        // steps = taps x k-tiles, a multiple of G (k-tiles is a multiple of 4)
        for (int s = 0; s < steps; s += G) {
            uint32_t af[G][4];
            const uint32_t group = ring_wait(ring);
#pragma unroll
            for (int q = 0; q < G; ++q) {
                const int row = row_base + tap * shift_step;
                const bf16* arow = (row >= 0 && row < rows) ? a + static_cast<size_t>(row) * chan : zero_row;
                ldmatrix_x4(af[q], arow + ((((kt << 1) | lchunk) ^ (row & 7)) << 3));
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
            for (int q = 0; q < G; ++q) Wgmma<N>::mma(acc, af[q], b_desc(group + q * slab_bytes + b_off));
            wgmma_commit();
            wgmma_wait<0>();
            ring_release(ring, cv);
        }
        fence_acc(acc);
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
            const int col = part * N + j * 8 + (lane & 3) * 2;
            const float b0 = __bfloat162float(bias[col]);
            const float b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
            for (int half = 0; half < 2; ++half)
                store(row0 + wrow + (lane >> 2) + half * 8, col, acc[4 * j + 2 * half] + b0,
                      acc[4 * j + 2 * half + 1] + b1);
        }
    }
}

// The branch chains of mrf_branch.cuh with each conv on its own rows
// (`tiles`) and its weights streamed through `ring`.  load_x0() fills w.xb
// with the masked stage input; result(row, col, m0, m1) receives the stage's
// result for rows acc_row0 .. acc_row0 + acc_rows, once per element pair.
// Ends with a barrier.
template <int N, int WGS, typename LoadX0, typename Result>
__device__ __forceinline__ void stage_branches(const MrfWindow& w, const MrfMeta& meta, const ConvTiles& tiles,
                                               WeightRing& ring, const bf16* __restrict__ bias, LoadX0 load_x0,
                                               Result result) {
    const int c = w.chan;
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
            conv_wgmma<N, WGS, true>(w.xb, w.rows, tiles.first[cv], tiles.count[cv], c, w.zero_row, k, -half * d, d,
                                     bias, slope, ring, cv, [&](int row, int col, float v0, float v1) {
                                         // bf16(y), then the leaky ReLU on the pair: the
                                         // product rounds once, as lrelu_bf16's does
                                         const bf162 y = __floats2bfloat162_rn(v0, v1);
                                         const uint32_t a = live(row) ? lrelu_pair(
                                             *reinterpret_cast<const uint32_t*>(&y), slope) : 0u;
                                         *reinterpret_cast<uint32_t*>(w.xt + at(row, col, c)) = a;
                                     });
            bias += c;
            __syncthreads();
            const bool last_pair = pair == meta.n_pairs - 1;
            conv_wgmma<N, WGS, false>(
                w.xt, w.rows, tiles.first[cv + 1], tiles.count[cv + 1], c, w.zero_row, k, -half, 1, bias, slope,
                ring, cv + 1, [&](int row, int col, float v0, float v1) {
                    bf162* px = reinterpret_cast<bf162*>(w.xb + at(row, col, c));
                    float n0 = 0.f, n1 = 0.f;
                    if (live(row)) {
                        const float2 cur = __bfloat1622float2(*px);
                        n0 = round_bf16(cur.x + round_bf16(v0));
                        n1 = round_bf16(cur.y + round_bf16(v1));
                    }
                    *px = __floats2bfloat162_rn(n0, n1);
                    const int arow = row - w.acc_row0;
                    if (last_pair && arow >= 0 && arow < w.acc_rows) {
                        // a finished branch's output is parked as bf16 and
                        // summed in f32, in order, by the last branch; each
                        // thread reads back only what it wrote itself
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

template <int N, int WGS>
__global__ void __launch_bounds__(WGS * 128, 1)
mrf_stage_kernel(const bf16* __restrict__ x, const int* __restrict__ lengths,
                 const unsigned char* __restrict__ wslabs, const bf16* __restrict__ bias,
                 bf16* __restrict__ out, bf16* __restrict__ scratch, int t_len, int chan, int rows,
                 int tile, int stages, MrfMeta meta, ConvTiles tiles) {
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + (SLAB_ALIGN - smem_u32(smem_raw) % SLAB_ALIGN) % SLAB_ALIGN;
    constexpr int G = group_steps(N);
    WeightRing ring;
    ring.slabs = smem;
    ring.wsrc = wslabs;
    ring.stages = stages / G;
    ring.group_bytes = G * 32 * chan;
    ring.n_warps = WGS * 4;
    ring.g = ring.stage = ring.r = ring.r_stage = ring.turn = 0;
    ring.phase = ring.r_phase = 0;
    bf16* zero_row = reinterpret_cast<bf16*>(smem + ring_bytes(chan, stages));
    bf16* xb = zero_row + chan;
    bf16* xt = xb + static_cast<size_t>(rows) * chan;

    const int b = blockIdx.y;
    bf16* parked = scratch + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * (meta.n_branches - 1) *
                                 tile * chan;
    const int halo = (rows - tile) / 2;
    const int t0 = blockIdx.x * tile;
    const int pos0 = t0 - halo;
    const int length = min(lengths[b], t_len);
    const int tid = threadIdx.x, n_threads = blockDim.x;
    for (int i = tid; i < chan; i += n_threads) zero_row[i] = __float2bfloat16_rn(0.f);
    if (tid == 0) {
        for (int s = 0; s < ring.stages; ++s) {
            mbar_init(ring.full() + s, 1);
            mbar_init(ring.empty() + s, ring.n_warps);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        RingPlan& plan = *reinterpret_cast<RingPlan*>(ring.empty() + ring.stages);
        const int k_tiles = chan / 16, n_parts = chan / N;
        int end = 0, first = 0;
        for (int cv = 0; cv < 2 * meta.n_branches * meta.n_pairs; ++cv) {
            // a round's slabs, taps x k-tiles, are a multiple of G (k-tiles is a multiple of 4)
            const int round_groups = meta.ksize[cv / (2 * meta.n_pairs)] * k_tiles / G;
            const int rounds = (tiles.count[cv] * n_parts + WGS - 1) / WGS;
            end += rounds * round_groups;
            plan.group_end[cv] = end;
            plan.round_groups[cv] = round_groups;
            plan.first_group[cv] = first;
            first += round_groups;
        }
        plan.total = end;
        // the first `stages` groups; each later one is copied as a group is released
        for (int s = 0; s < ring.stages; ++s) ring_copy(ring, s, s, 0);
    }
    __syncthreads();

    MrfWindow w;
    w.xb = xb; w.xt = xt; w.parked = parked; w.zero_row = zero_row;
    w.rows = rows; w.ld = chan; w.chan = chan;
    w.acc_row0 = halo; w.acc_rows = tile;
    w.pos0 = pos0; w.length = length;

    const bf16* xrow = x + static_cast<size_t>(b) * t_len * chan;
    bf16* orow = out + static_cast<size_t>(b) * t_len * chan;
    const int vec = chan / 8;
    stage_branches<N, WGS>(
        w, meta, tiles, ring, bias,
        [&]() {
            const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
            for (int i = tid; i < rows * vec; i += n_threads) {
                const int row = i / vec, c8 = (i % vec) * 8;
                const int pos = pos0 + row;
                uint4 v = zero4;
                if (pos >= 0 && pos < length)
                    v = *reinterpret_cast<const uint4*>(xrow + static_cast<size_t>(pos) * chan + c8);
                *reinterpret_cast<uint4*>(xb + at(row, c8, chan)) = v;
            }
        },
        [&](int row, int col, float m0, float m1) {
            const int pos = pos0 + row;
            if (pos < t_len)
                *reinterpret_cast<bf162*>(orow + static_cast<size_t>(pos) * chan + col) =
                    __floats2bfloat162_rn(m0, m1);
        });
}

// The kernel instance of a product width and warpgroup count, or null.
typedef void (*KernelFn)(const bf16*, const int*, const unsigned char*, const bf16*, bf16*, bf16*, int, int, int,
                         int, int, MrfMeta, ConvTiles);

KernelFn kernel_for(int width, int warpgroups) {
    switch (width * 8 + warpgroups) {
        case 64 * 8 + 3: return mrf_stage_kernel<64, 3>;
        case 128 * 8 + 2: return mrf_stage_kernel<128, 2>;
        case 128 * 8 + 3: return mrf_stage_kernel<128, 3>;
        case 128 * 8 + 4: return mrf_stage_kernel<128, 4>;
        case 256 * 8 + 2: return mrf_stage_kernel<256, 2>;
        case 256 * 8 + 3: return mrf_stage_kernel<256, 3>;
        default: return nullptr;
    }
}

}  // namespace

// Shared memory of one block, in bytes, with a weight ring of `stages` slabs:
// room to align the ring, the slabs, their barriers and the ring's plan, then
// the window (a row of zeros and the two buffers), 16-byte aligned
// throughout as the bulk copies and ldmatrix ask.
extern "C" int mrf_stage_smem_bytes(int chan, int rows, int stages) {
    return SLAB_ALIGN + ring_bytes(chan, stages) + (1 + 2 * rows) * chan * 2;
}

// Registers a thread and local (spilled) bytes of the kernel instance of a
// product width and warpgroup count: out[0], out[1].  Returns the CUDA error
// (0 on success), -1 for an instance that does not exist.
extern "C" int mrf_stage_attributes(int width, int warpgroups, int* out) {
    const KernelFn fn = kernel_for(width, warpgroups);
    if (fn == nullptr) return -1;
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
    return 0;
}

// x, out [batch, t_len, chan] bf16; lengths [batch] int32 true sample counts;
// wslabs: all taps in execution order, [n_taps][C/16] slabs of wgmma.cuh's
// B layout (32 * C bytes each); bias [n_convs][C] bf16; ksizes [n_branches];
// dilations [n_branches][n_pairs]; tiles [n_convs][2]: each conv's first
// window row and its nonzero count of 64-row tiles, inside [0, rows);
// stages: the weight ring's slabs, a multiple of group_steps(width) up to
// 16; width and warpgroups: an instance of kernel_for (width dividing chan);
// scratch: batch *
// ceil(t_len / tile) * (n_branches - 1) * tile * chan bf16.  chan % 64 == 0;
// rows - tile is twice the halo.  Returns the CUDA error of the launch (0 on
// success), -1 for too many branches or pairs, a bad tile range, ring depth,
// width or warpgroup count.
extern "C" int mrf_stage_bf16(const void* x, const int* lengths, const void* wslabs, const void* bias,
                              void* out, void* scratch, int batch, int t_len, int chan,
                              int n_branches, int n_pairs, const int* ksizes, const int* dilations,
                              const int* tiles, int rows, int tile, int stages, int width, int warpgroups,
                              int device, void* stream) {
    if (n_branches < 1 || n_branches > MAX_BRANCHES || n_pairs < 1 || n_pairs > MAX_PAIRS) return -1;
    const KernelFn fn = kernel_for(width, warpgroups);
    if (fn == nullptr || chan % 64 || chan % width || stages < group_steps(width) ||
        stages % group_steps(width) || stages > MAX_STAGES)
        return -1;
    ConvTiles ct;
    for (int i = 0; i < MAX_CONVS; ++i) {
        const bool used = i < 2 * n_branches * n_pairs;
        ct.first[i] = used ? tiles[2 * i] : 0;
        ct.count[i] = used ? tiles[2 * i + 1] : 0;
        if (used && (ct.first[i] < 0 || ct.count[i] < 1 || ct.first[i] + ct.count[i] * TILE_M > rows)) return -1;
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int smem = mrf_stage_smem_bytes(chan, rows, stages);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((t_len + tile - 1) / tile, batch);
    fn<<<grid, warpgroups * 128, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), lengths, static_cast<const unsigned char*>(wslabs),
        static_cast<const bf16*>(bias), static_cast<bf16*>(out), static_cast<bf16*>(scratch), t_len, chan,
        rows, tile, stages, make_meta(n_branches, n_pairs, ksizes, dilations), ct);
    return static_cast<int>(cudaGetLastError());
}
