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
// running residual and the second conv's operand.  The halo is recomputed by
// both neighbours, but each conv computes only the rows that the convs after
// it in its branch still read: conv j of a branch is needed on the kept tile
// widened by the reaches of the convs after it (ops/mrf_cuda.py::conv_chunks
// computes the ranges on the host, in 16-row chunks), so the shallow
// branches and the late convs of the deep one skip most of the halo.  Rows
// outside a conv's range are not written and hold stale values, which only
// rows outside the next conv's range read.  The stage input is read again
// from device memory (L2) at the start of each branch instead of being kept
// in a third buffer, and the finished branches' outputs wait in a scratch
// buffer in device memory until the last branch sums them (each thread reads
// back only what it wrote itself, so no barrier guards it).
//
// The weights reach the tensor cores through a ring of slabs in shared
// memory, filled by 1-D bulk async copies that complete on mbarriers (below):
// a block reads each conv's weights from L2 once a round (12 warps of two
// 32 x 32 output tiles each), not once per tile, and a product waits on
// shared memory, not on L2.  What holds the kernel on an H100 is not the
// weight traffic but the mma.sync path itself (ldmatrix, fragment loads,
// m16n8k16 issue): one block alone takes as long as a full grid, so blocks
// do not contend for L2.  The ring is also the operand path that wgmma,
// which reads B from shared memory, needs.  Products run on the tensor cores
// with mma_tile.cuh's fragments.

#include "mrf_branch.cuh"

using namespace ovt;

namespace {

constexpr int MAX_CONVS = MAX_BRANCHES * MAX_PAIRS * 2;
constexpr int CHUNK_ROWS = 16;  // the row granularity of a conv's range: one m16 tile
// Each warp computes IPW output tiles a round, so a round of 12 warps covers
// 24 tiles and a conv's weights stream through the ring fewer times; the
// 64 accumulators this takes fit only under 170 registers, at 384 threads.
constexpr int IPW = 2;
constexpr int MAX_THREADS = 384;
constexpr int MAX_STAGES = 16;  // slabs the weight ring holds at most

// The window rows each conv computes, in execution order: chunks
// [first, first + count) of CHUNK_ROWS rows; count is even (a warp tile is
// two chunks).
struct ConvChunks {
    int first[MAX_CONVS], count[MAX_CONVS];
};

// -- mbarrier and bulk-copy primitives (shared::cta addresses) ---------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
                 : "memory");
}

// Spin until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
    } while (!done);
}

// One 1-D bulk copy global -> shared whose bytes complete a transaction on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// -- the weight ring -----------------------------------------------------------
//
// A slab is the packed weights of one (tap, k-tile): C/8 column tiles x 32
// lanes x 8 bytes = 32 * C bytes, contiguous in fragment order, and a conv's
// slabs are consecutive.  Every warp walks the same sequence of slabs: for
// each conv, for each round of up to IPW items a warp (32-row x 32-column
// output tiles), for each tap and k-tile, one slab.  The ring holds `stages`
// slabs: slab g lives in stage g % stages; its "full" barrier completes when
// its bytes land, its "empty" barrier when every warp has read it (a warp
// with no item in the round arrives all the same).  When a warp has read
// slab g, it copies slab g + stages - 1 into the stage of slab g - 1, once
// every warp has released that one, if it is that slab's turn: the warps take
// the copies in turn, so that no warp carries the issue cost of every slab
// and the copies run stages - 1 slabs ahead of the reads, across rounds,
// convs and the block's barriers.  The issuing warp waits converged, so the
// .aligned ldmatrix and mma.sync that follow see the whole warp.  A slab's
// source follows from its index through a small plan in shared memory.

struct RingPlan {
    int slab_end[MAX_CONVS];     // slabs of convs 0 .. cv, every round
    int round_slabs[MAX_CONVS];  // slabs of one round of conv cv: taps x k-tiles
    int first_slab[MAX_CONVS];   // conv cv's weights start at this slab of wfrag
    int total;
};

struct WeightRing {
    uint2* slabs;        // [stages][slab_words] in shared memory; the barriers and the plan follow
    const uint2* wfrag;  // every conv's weights, in execution order
    int stages, slab_words, n_warps;
    int g;               // the slab this warp reads next
    int stage;           // g % stages
    uint32_t phase;      // (g / stages) & 1
    int turn;            // the warp that copies the slab g + stages - 1
    __device__ uint64_t* full() const { return reinterpret_cast<uint64_t*>(slabs + stages * slab_words); }
    __device__ uint64_t* empty() const { return full() + stages; }
    __device__ const RingPlan& plan() const { return *reinterpret_cast<const RingPlan*>(empty() + stages); }
};

__host__ __device__ __forceinline__ int ring_bytes(int chan, int stages) {
    const int plan = (static_cast<int>(sizeof(RingPlan)) + 15) / 16 * 16;
    return stages * (32 * chan + 2 * static_cast<int>(sizeof(uint64_t))) + plan;
}

// One thread: copy slab p into `stage`.  `cv` is a conv at or before p's.
__device__ __forceinline__ void ring_copy(const WeightRing& ring, int p, int stage, int cv) {
    const RingPlan& plan = ring.plan();
    if (p >= plan.total) return;
    while (p >= plan.slab_end[cv]) ++cv;
    const int start = cv ? plan.slab_end[cv - 1] : 0;
    const int slab = plan.first_slab[cv] + (p - start) % plan.round_slabs[cv];
    const uint32_t bytes = static_cast<uint32_t>(ring.slab_words) * sizeof(uint2);
    mbar_expect_tx(ring.full() + stage, bytes);
    bulk_copy(ring.slabs + static_cast<size_t>(stage) * ring.slab_words,
              ring.wfrag + static_cast<size_t>(slab) * ring.slab_words, bytes, ring.full() + stage);
}

// Wait until the slab this warp reads next has landed; returns it.
__device__ __forceinline__ const uint2* ring_wait(const WeightRing& ring) {
    mbar_wait(ring.full() + ring.stage, ring.phase);
    return ring.slabs + static_cast<size_t>(ring.stage) * ring.slab_words;
}

// This warp is done with its slab g (of conv `cv`): release it; the warp
// whose turn it is then refills the stage of slab g - 1 with slab
// g + stages - 1.
__device__ __forceinline__ void ring_release(WeightRing& ring, int cv) {
    const int lane = threadIdx.x & 31;
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty() + ring.stage);
    if ((threadIdx.x >> 5) == ring.turn) {
        const int stage = ring.stage == 0 ? ring.stages - 1 : ring.stage - 1;
        const uint32_t phase = ring.stage == 0 ? ring.phase : ring.phase ^ 1u;
        // the stage's last slab released by every warp (passes at once on
        // its first fill)
        mbar_wait(ring.empty() + stage, phase ^ 1u);
        if (lane == 0) ring_copy(ring, ring.g + ring.stages - 1, stage, cv);
        __syncwarp();
    }
    if (++ring.turn == ring.n_warps) ring.turn = 0;
    ++ring.g;
    if (++ring.stage == ring.stages) {
        ring.stage = 0;
        ring.phase ^= 1u;
    }
}

// One conv over the output rows of chunks [c0, c0 + count), its weights
// streamed through the ring:
//   y[r, n] = bias[n] + sum_i A[r + shift0 + i * shift_step, :] @ W[i][:, n]
// A comes from shared memory by ldmatrix (rows outside [0, a_rows) read
// `zero_row`), B from the ring stage as one 8-byte word a lane at
// (nt * 32 + lane).  Each element pair goes once through store(r, n, y0, y1).
// No block barrier inside.
template <bool LRELU, typename Store>
__device__ __forceinline__ void conv_ring(const bf16* a, int lda, int a_rows, int c0, int count, int chan,
                                          const bf16* zero_row, int n_taps, int shift0, int shift_step,
                                          const bf16* __restrict__ bias, bf162 slope, WeightRing& ring, int cv,
                                          Store store) {
    const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5, lane = threadIdx.x & 31;
    const int n_tiles = chan >> 3, n_groups = (n_tiles + NT - 1) / NT, k_tiles = chan >> 4;
    const int m_tiles = count / MT, n_items = m_tiles * n_groups;
    const int lrow = lane & 15, lcol = (lane >> 4) * 8;
    for (int round0 = 0; round0 < n_items; round0 += n_warps * IPW) {
        // a warp takes IPW consecutive items; neighbouring warps take the same
        // columns of neighbouring row tiles
        bool busy[IPW];
        int row0[IPW], nt[IPW][NT];
        Acc acc[IPW];
#pragma unroll
        for (int it = 0; it < IPW; ++it) {
            const int item = round0 + warp * IPW + it;
            busy[it] = item < n_items;
            const int ng = busy[it] ? item / m_tiles : 0, mc = busy[it] ? item % m_tiles : 0;
            row0[it] = (c0 + mc * MT) * CHUNK_ROWS;
#pragma unroll
            for (int j = 0; j < NT; ++j) nt[it][j] = (ng * NT + j < n_tiles) ? ng * NT + j : -1;
            zero_acc(acc[it]);
        }
        for (int i = 0; i < n_taps; ++i) {
            const bf16* arow[IPW][MT];
#pragma unroll
            for (int it = 0; it < IPW; ++it)
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    const int row = row0[it] + shift0 + i * shift_step + mt * 16 + lrow;
                    arow[it][mt] = (row >= 0 && row < a_rows) ? a + static_cast<size_t>(row) * lda + lcol
                                                              : zero_row + lcol;
                }
            for (int kt = 0; kt < k_tiles; ++kt) {
                const uint2* slab = ring_wait(ring);
#pragma unroll
                for (int it = 0; it < IPW; ++it) {
                    if (!busy[it]) continue;
                    uint32_t af[MT][4];
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
                        ldmatrix_x4(af[mt], arow[it][mt] + kt * 16);
                        if (LRELU) {
#pragma unroll
                            for (int q = 0; q < 4; ++q) af[mt][q] = lrelu_pair(af[mt][q], slope);
                        }
                    }
#pragma unroll
                    for (int j = 0; j < NT; ++j) {
                        if (nt[it][j] < 0) continue;
                        const uint2 b = slab[nt[it][j] * 32 + lane];
#pragma unroll
                        for (int mt = 0; mt < MT; ++mt) mma_16816(acc[it][mt][j], af[mt], b);
                    }
                }
                ring_release(ring, cv);
            }
        }
#pragma unroll
        for (int it = 0; it < IPW; ++it) {
            if (!busy[it]) continue;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                if (nt[it][j] < 0) continue;
                const int col = nt[it][j] * 8 + (lane & 3) * 2;
                const float b0 = __bfloat162float(bias[col]);
                const float b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int half = 0; half < 2; ++half)
                        store(row0[it] + mt * 16 + (lane >> 2) + half * 8, col, acc[it][mt][j][2 * half] + b0,
                              acc[it][mt][j][2 * half + 1] + b1);
            }
        }
    }
}

// The branch chains of mrf_branch.cuh with each conv on its own rows
// (`chunks`) and its weights streamed through `ring`.  load_x0() fills w.xb
// with the masked stage input; result(row, col, m0, m1) receives the stage's
// result for rows acc_row0 .. acc_row0 + acc_rows, once per element pair.
// Ends with a barrier.
template <typename LoadX0, typename Result>
__device__ __forceinline__ void stage_branches(const MrfWindow& w, const MrfMeta& meta, const ConvChunks& chunks,
                                               WeightRing& ring, const bf16* __restrict__ bias, LoadX0 load_x0,
                                               Result result) {
    const int c = w.chan;
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
            conv_ring<true>(w.xb, w.ld, w.rows, chunks.first[cv], chunks.count[cv], c, w.zero_row, k, -half * d, d,
                            bias, slope, ring, cv, [&](int row, int col, float v0, float v1) {
                                const bool ok = live(row);
                                const float a0 = ok ? lrelu_bf16(round_bf16(v0), slope_f) : 0.f;
                                const float a1 = ok ? lrelu_bf16(round_bf16(v1), slope_f) : 0.f;
                                *reinterpret_cast<bf162*>(w.xt + static_cast<size_t>(row) * w.ld + col) =
                                    __floats2bfloat162_rn(a0, a1);
                            });
            bias += c;
            __syncthreads();
            const bool last_pair = pair == meta.n_pairs - 1;
            conv_ring<false>(
                w.xt, w.ld, w.rows, chunks.first[cv + 1], chunks.count[cv + 1], c, w.zero_row, k, -half, 1, bias,
                slope, ring, cv + 1, [&](int row, int col, float v0, float v1) {
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

__global__ void __launch_bounds__(MAX_THREADS, 1)
mrf_stage_kernel(const bf16* __restrict__ x, const int* __restrict__ lengths,
                 const uint2* __restrict__ wfrag, const bf16* __restrict__ bias,
                 bf16* __restrict__ out, bf16* __restrict__ scratch, int t_len, int chan, int rows,
                 int tile, int stages, MrfMeta meta, ConvChunks chunks) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int ld = chan + LD_PAD;
    const int slab_words = 4 * chan;  // 32 * chan bytes
    WeightRing ring;
    ring.slabs = reinterpret_cast<uint2*>(smem);
    ring.wfrag = wfrag;
    ring.stages = stages;
    ring.slab_words = slab_words;
    ring.n_warps = blockDim.x >> 5;
    ring.g = ring.stage = 0;
    ring.phase = 0;
    ring.turn = (stages - 1) % ring.n_warps;
    bf16* zero_row = reinterpret_cast<bf16*>(smem + ring_bytes(chan, stages));
    bf16* xb = zero_row + ld;
    bf16* xt = xb + static_cast<size_t>(rows) * ld;

    const int b = blockIdx.y;
    bf16* parked = scratch + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * (meta.n_branches - 1) *
                                 tile * chan;
    const int halo = (rows - tile) / 2;
    const int t0 = blockIdx.x * tile;
    const int pos0 = t0 - halo;
    const int length = min(lengths[b], t_len);
    const int tid = threadIdx.x, n_threads = blockDim.x;
    for (int i = tid; i < ld; i += n_threads) zero_row[i] = __float2bfloat16_rn(0.f);
    if (tid == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(ring.full() + s, 1);
            mbar_init(ring.empty() + s, ring.n_warps);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        RingPlan& plan = *reinterpret_cast<RingPlan*>(ring.empty() + stages);
        const int k_tiles = chan / 16, n_groups = (chan / 8 + NT - 1) / NT;
        int end = 0, first = 0;
        for (int cv = 0; cv < 2 * meta.n_branches * meta.n_pairs; ++cv) {
            const int round_slabs = meta.ksize[cv / (2 * meta.n_pairs)] * k_tiles;
            const int rounds = (chunks.count[cv] / MT * n_groups + ring.n_warps * IPW - 1) / (ring.n_warps * IPW);
            end += rounds * round_slabs;
            plan.slab_end[cv] = end;
            plan.round_slabs[cv] = round_slabs;
            plan.first_slab[cv] = first;
            first += round_slabs;
        }
        plan.total = end;
        // the first stages - 1 slabs; each later one is copied as a slab is released
        for (int s = 0; s < stages - 1; ++s) ring_copy(ring, s, s, 0);
    }
    __syncthreads();

    MrfWindow w;
    w.xb = xb; w.xt = xt; w.parked = parked; w.zero_row = zero_row;
    w.rows = rows; w.ld = ld; w.chan = chan;
    w.acc_row0 = halo; w.acc_rows = tile;
    w.pos0 = pos0; w.length = length;

    const bf16* xrow = x + static_cast<size_t>(b) * t_len * chan;
    bf16* orow = out + static_cast<size_t>(b) * t_len * chan;
    const int vec = chan / 8;
    stage_branches(
        w, meta, chunks, ring, bias,
        [&]() {
            const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
            for (int i = tid; i < rows * vec; i += n_threads) {
                const int row = i / vec, c8 = (i % vec) * 8;
                const int pos = pos0 + row;
                uint4 v = zero4;
                if (pos >= 0 && pos < length)
                    v = *reinterpret_cast<const uint4*>(xrow + static_cast<size_t>(pos) * chan + c8);
                *reinterpret_cast<uint4*>(xb + static_cast<size_t>(row) * ld + c8) = v;
            }
        },
        [&](int row, int col, float m0, float m1) {
            const int pos = pos0 + row;
            if (pos < t_len)
                *reinterpret_cast<bf162*>(orow + static_cast<size_t>(pos) * chan + col) =
                    __floats2bfloat162_rn(m0, m1);
        });
}

}  // namespace

// Shared memory of one block, in bytes, with a weight ring of `stages` slabs:
// the slabs, their barriers and the ring's plan, then the window (a row of
// zeros and the two buffers), 16-byte aligned throughout as the bulk copies
// and ldmatrix ask.
extern "C" int mrf_stage_smem_bytes(int chan, int rows, int stages) {
    const int ld = chan + LD_PAD;
    return ring_bytes(chan, stages) + (1 + 2 * rows) * ld * 2;
}

// x, out [batch, t_len, chan] bf16; lengths [batch] int32 true sample counts;
// wfrag: all taps in execution order, [n_taps][C/16][C/8][32] fragment words;
// bias [n_convs][C] bf16; ksizes [n_branches]; dilations [n_branches][n_pairs];
// chunks [n_convs][2]: each conv's first 16-row chunk of the window and its
// even, nonzero chunk count, inside [0, rows / 16); stages: the weight ring's
// slabs, 2 .. 16; scratch: batch * ceil(t_len / tile) * (n_branches - 1) *
// tile * chan bf16.  chan % 16 == 0; rows % 32 == 0; rows - tile is twice the
// halo; threads a multiple of 32 up to 384.  Returns the CUDA error of the
// launch (0 on success), -1 for too many branches or pairs, a bad chunk
// range, ring depth or thread count.
extern "C" int mrf_stage_bf16(const void* x, const int* lengths, const void* wfrag, const void* bias,
                              void* out, void* scratch, int batch, int t_len, int chan,
                              int n_branches, int n_pairs, const int* ksizes, const int* dilations,
                              const int* chunks, int rows, int tile, int stages, int threads, int device,
                              void* stream) {
    if (n_branches < 1 || n_branches > MAX_BRANCHES || n_pairs < 1 || n_pairs > MAX_PAIRS) return -1;
    if (stages < 2 || stages > MAX_STAGES || threads < 32 || threads > MAX_THREADS || threads % 32) return -1;
    ConvChunks cc;
    for (int i = 0; i < MAX_CONVS; ++i) {
        const bool used = i < 2 * n_branches * n_pairs;
        cc.first[i] = used ? chunks[2 * i] : 0;
        cc.count[i] = used ? chunks[2 * i + 1] : 0;
        if (used && (cc.first[i] < 0 || cc.count[i] < MT || cc.count[i] % MT ||
                     (cc.first[i] + cc.count[i]) * CHUNK_ROWS > rows))
            return -1;
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int smem = mrf_stage_smem_bytes(chan, rows, stages);
    err = cudaFuncSetAttribute(mrf_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((t_len + tile - 1) / tile, batch);
    mrf_stage_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), lengths, static_cast<const uint2*>(wfrag),
        static_cast<const bf16*>(bias), static_cast<bf16*>(out), static_cast<bf16*>(scratch), t_len,
        chan, rows, tile, stages, make_meta(n_branches, n_pairs, ksizes, dilations), cc);
    return static_cast<int>(cudaGetLastError());
}
