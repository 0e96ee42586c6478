// The weight ring of the kernels that stream their weights through shared
// memory in bulk copies: K3 (mrf.cu) and K4 (tail.cu) through mrf_core.cuh,
// K1 (wn.cu) and K2 (coupling.cu) through wn_cluster.cuh.  Here: `Ring`,
// `RingPlan`, `make_plan`, `ring_start`, `ring_copy`, `ring_wait` and
// `ring_release`.  K1 and K2 count their streams in units of a narrow
// product's slab, a wide product's slab being two (wn_cluster.cuh).

#pragma once

#include "bulk_copy.cuh"

namespace ovt {

constexpr int MAX_SEQ = 40;                      // product entries a launch (K4: 8 phases and 32 convs; K2: 4 x 10)
constexpr int TILE_M = 64;                       // rows of one wgmma tile
constexpr int MAX_GROUP = 16;                    // slabs of one ring group
constexpr int MAX_STAGES = 32;                   // groups the ring holds at most
constexpr int SLAB_ALIGN = 256;                  // the 32-byte swizzle's period: slabs start on it
constexpr int PLAN_FIELDS = 5;                   // a plan entry from the host: first, count, steps, slab0, group_end

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

// The host's plan of a launch (ops/_frag.py::ring_plan), in the kernel's
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

}  // namespace ovt
