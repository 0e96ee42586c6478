// K2: one direction of the converter's coupling flow in one launch.
//
// Replaces the TPU kernel openvoice_tpu/ops/coupling_pallas.py::
// fused_coupling_block (body _coupling_kernel).  Per coupling step s, in
// execution order (the host packs forward or reverse order, folds the channel
// Flip into the pre/post matrices and negates post for reverse):
//   h     = bf16(state @ Wp[s] + bp[s]) * mask
//   skip  = WaveNet(h), L layers as in K1 (wn_cluster.cuh), f32
//   m     = bf16(skip) * mask
//   state = bf16(state + bf16(m @ Wq[s] + bq[s])) * mask
// The state starts as x * mask; frames past the length come out exactly 0.
//
// What bounds it: operations, as K1 (15 GFLOP a direction at T=1024, C=H=192,
// S=4, L=4, K=5, against 14.7 MB of weights), in one dependent chain of
// S*(2L+2) products.  At B = 1 the chain's latency is what takes the time.
//
// Design: time tiles with a recomputed halo of S*L*(K-1)/2 frames a side,
// each tile on a cluster of R CTAs (thread-block cluster) on R SMs.  Every
// CTA keeps its own copy of the window's bf16 buffers (the [rows, C] state,
// the WaveNet's residual `hs` and gate output `acts`) and computes a 1/R
// share of every product's output columns, as the host's plan says
// (ops/_frag.py::cluster_bounds): rank r owns C-column tiles [c[r], c[r+1])
// of the post product and H-channel tiles [h[r], h[r+1]) of the pre, gate
// and res|skip products, for gate and res|skip those channels of both
// halves.  Every product is a wgmma product of the CTA's columns
// (wn_cluster.cuh), its share of the weights streamed through a
// shared-memory ring in execution order: per step pre, the WaveNet's layers
// (the gate's K taps, then res|skip), post.  A warp stores its finished rows
// into its own copy, then copies them into the peers' copies through
// distributed shared memory, 16 bytes a lane and row, and a cluster barrier
// (release / acquire) follows every product, so each product reads a
// complete local copy.  A read-modify-write reads the local copy and stores
// the same bits everywhere, so the copies stay identical.  The f32 skip sum
// holds the CTA's own channels only; on the last layer it is final, and its
// rounded, masked value goes to `hs`, which the post product reads (the gate
// is the last reader of `hs` before it).  So one barrier per product: 2L + 2
// a step, each product waiting on the one before it only once its first
// weights are in.  The ring runs ahead across them: the next product's first
// slabs land while a product's epilogue, push and barrier run.

#include "wn_cluster.cuh"

using namespace ovt;
namespace cg = cooperative_groups;

namespace {

// The last WaveNet layer's output, rounded once and masked, goes into the
// same columns of hs: the post product's operand (the gate is the last
// reader of hs before it).
struct IntoHs {
    static constexpr bool kIntoXs = true;
    ChunkRows hs;
    __device__ __forceinline__ void operator()(int row, int col, float v0, float v1) const {
        store_pair(hs.at(row, col), v0, v1);
    }
};

__global__ void __launch_bounds__(WN_WARPGROUPS * 128, 1)
coupling_kernel(const bf16* __restrict__ x, const int* __restrict__ lengths,
                const unsigned char* __restrict__ streams, const bf16* __restrict__ bp,
                const bf16* __restrict__ b_in, const bf16* __restrict__ g_all, const bf16* __restrict__ b_rs,
                const bf16* __restrict__ bq, bf16* __restrict__ out, int t_len, int chan, int hidden, int ksize,
                int n_layers, int n_steps, int rows, int tile, int share, int skip_ld, int parts, int unit_bytes,
                RingPlan plan) {
    // WN_WIDTH columns of an item of a wide product (the gate, res|skip), half
    // that of a narrow one (pre, post, the last layer's skip)
    constexpr int NW = WN_WIDTH;
    constexpr int NP = NW / 16;  // channel tiles of an item
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + (SLAB_ALIGN - smem_u32(smem_raw) % SLAB_ALIGN) % SLAB_ALIGN;
    const cg::cluster_group cluster = cg::this_cluster();
    const int ranks = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    Ring ring;
    const unsigned char* stream = streams + static_cast<size_t>(rank) * plan.slabs * unit_bytes;
    bf16* window = reinterpret_cast<bf16*>(ring_start<WN_WARPGROUPS, WN_GROUP>(ring, plan, smem, stream, unit_bytes));
    const int prows = chunk_rows(rows);
    const ChunkRows state{window, prows};
    const ChunkRows hs{window + static_cast<size_t>(chan / 8) * prows * 8, prows};
    const ChunkRows acts{hs.base + static_cast<size_t>(hidden / 8) * prows * 8, prows};
    float* skip = reinterpret_cast<float*>(acts.base + static_cast<size_t>(hidden / 8) * prows * 8);  // [rows][skip_ld]

    const int b = blockIdx.y;
    const int halo = (rows - tile) / 2;
    const int t0 = static_cast<int>(blockIdx.x / ranks) * tile;
    const int frame0 = t0 - halo;
    const int length = min(lengths[b], t_len);
    const int tid = threadIdx.x, n_threads = blockDim.x, lane = tid & 31;
    const int h0 = rank * share, c0 = rank * share;  // equal shares of C and H tiles

    // every CTA loads the whole window into its own copy
    zero_pads(state, chan, rows);
    zero_pads(hs, hidden, rows);
    zero_pads(acts, hidden, rows);
    const int vec = chan / 8;
    const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < rows * vec; i += n_threads) {
        const int row = i / vec, c8 = (i % vec) * 8;
        const int frame = frame0 + row;
        uint4 v = zero4;
        if (frame >= 0 && frame < length)
            v = *reinterpret_cast<const uint4*>(x + (static_cast<size_t>(b) * t_len + frame) * chan + c8);
        *reinterpret_cast<uint4*>(state.at(row, c8)) = v;
    }
    // the first product waits on this barrier: no CTA stores into a peer's
    // shared memory before the peer runs
    cluster_arrive();

    auto live = [&](int row) { const int f = frame0 + row; return f >= 0 && f < length; };
    const int per_step = 2 * n_layers + 2;  // plan entries a step
    // this thread's first column of channel tile ct0 + j
    auto col_of = [&](int ct0, int j) { return (ct0 + j) * 8 + (lane & 3) * 2; };
    float2 bias[NP];  // a 1x1 product's biases of this thread's columns, loaded before the product

    for (int s = 0; s < n_steps; ++s) {
        // pre 1x1 (flip and half-select folded into the matrix): state -> hs
        cluster_product<NW / 2, 1>(
            state, chan / 16, 0, parts, ring, plan, s * per_step,
            [&](int part) {
#pragma unroll
                for (int j = 0; j < NP; ++j)
                    bias[j] = __bfloat1622float2(*reinterpret_cast<const bf162*>(bp + s * hidden +
                                                                                  col_of(h0 + part * NP, j)));
            },
            [&](float (&acc)[NW / 4], int row0, int part) {
                const int ct0 = h0 + part * NP;
#pragma unroll
                for (int j = 0; j < NP; ++j) {
                    const int col = col_of(ct0, j);
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        const int row = row0 + (lane >> 2) + half * 8;
                        const int i = 4 * j + 2 * half;
                        const bool ok = live(row);
                        store_pair(hs.at(row, col), ok ? acc[i] + bias[j].x : 0.f, ok ? acc[i + 1] + bias[j].y : 0.f);
                    }
                }
                push_rows<NP>(hs, row0, ct0, ranks, rank);
            });
        cluster_arrive();

        const WnShare w{hs, acts, skip, hidden, ksize, 0, rows, skip_ld, frame0, length, h0, parts, ranks, rank};
        wn_cluster_layers(w, ring, plan, s * per_step + 1, b_in, g_all, b_rs, s * n_layers,
                          (static_cast<size_t>(b) * n_steps + s) * n_layers, n_layers, IntoHs{hs});

        // post 1x1 (target half and sign folded in): hs -> the rank's state columns
        cluster_product<NW / 2, 1>(
            hs, hidden / 16, 0, parts, ring, plan, s * per_step + per_step - 1,
            [&](int part) {
#pragma unroll
                for (int j = 0; j < NP; ++j)
                    bias[j] = __bfloat1622float2(*reinterpret_cast<const bf162*>(bq + s * chan +
                                                                                  col_of(c0 + part * NP, j)));
            },
            [&](float (&acc)[NW / 4], int row0, int part) {
                const int ct0 = c0 + part * NP;
#pragma unroll
                for (int j = 0; j < NP; ++j) {
                    const int col = col_of(ct0, j);
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        const int row = row0 + (lane >> 2) + half * 8;
                        const int i = 4 * j + 2 * half;
                        bf16* ps = state.at(row, col);
                        const float2 cur = __bfloat1622float2(*reinterpret_cast<const bf162*>(ps));
                        const bool ok = live(row);
                        store_pair(ps, ok ? cur.x + round_bf16(acc[i] + bias[j].x) : 0.f,
                                   ok ? cur.y + round_bf16(acc[i + 1] + bias[j].y) : 0.f);
                    }
                }
                push_rows<NP>(state, row0, ct0, ranks, rank);
            });
        cluster_arrive();
    }
    // after the last product's barrier no peer stores into this CTA's shared
    // memory, and every copy of the state is whole
    cluster_wait();

    // the copies are identical: the ranks share out the kept rows
    for (int i = tid + rank * n_threads; i < tile * vec; i += n_threads * ranks) {
        const int r = i / vec, c8 = (i % vec) * 8;
        const int frame = t0 + r;
        if (frame >= t_len) continue;
        *reinterpret_cast<uint4*>(out + (static_cast<size_t>(b) * t_len + frame) * chan + c8) =
            *reinterpret_cast<const uint4*>(state.at(halo + r, c8));
    }
}

}  // namespace

// Shared memory of one CTA, in bytes: the ring (room to align it, its
// `ring_units` units of `unit_bytes` in `stages` groups and their barriers),
// the bf16 window (state, hs and acts, ChunkRows) and the f32 skip sum of
// skip_cols channels.
extern "C" int coupling_smem_bytes(int chan, int hidden, int rows, int skip_cols, int unit_bytes, int ring_units,
                                   int stages) {
    const long long bytes = cluster_ring_bytes(unit_bytes, ring_units, stages) + chunk_bytes(chan, rows) +
                            2 * chunk_bytes(hidden, rows) + 1LL * rows * skip_cols * 4;
    return bytes > 0x7fffffff ? 0x7fffffff : static_cast<int>(bytes);
}

// Registers a thread and local (spilled) bytes of the kernel: out[0],
// out[1] (cudaFuncGetAttributes).  Returns the CUDA error (0 on success).
extern "C" int coupling_attributes(int* out) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, coupling_kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
    return 0;
}

// cudaOccupancyMaxActiveClusters for a launch with clusters of `ranks` CTAs
// and `smem` bytes a CTA: how many clusters the card holds at once (0: the
// launch cannot run).  Returns the CUDA error (0 on success), -1 for a
// cluster size the kernel does not take.
extern "C" int coupling_max_clusters(int smem, int ranks, int device, int* clusters) {
    if (ranks < 1 || ranks > MAX_RANKS) return -1;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = cluster_launch_config(cfg, attr, coupling_kernel, dim3(ranks), WN_WARPGROUPS * 128, smem, ranks, nullptr);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, coupling_kernel, &cfg));
}

// x, out [batch, t_len, chan] bf16; lengths [batch] int32; streams [ranks]
// of each rank's weight stream (ops/_frag.py::cluster_streams), units of
// unit_bytes; per step s: bp [S][H], b_in, b_rs [S][L][2H], bq [S][C] bf16;
// g_all [batch][S][L][2H].  c_bounds, h_bounds: ranks + 1 tile boundaries
// each (the column plan; equal shares, as many C tiles as H tiles); skip_cols
// is 8 times a rank's H tiles.  plan [S(2L+2)][PLAN_FIELDS]: each product's
// first row (0), 64-row tiles, units a round, first unit and ring groups so
// far (ops/_frag.py::ring_plan; `make_plan` checks it); stages (2 to
// MAX_STAGES) groups of WN_GROUP units.  chan % 16 == hidden % 16 == 0; rows
// % 64 == 0; rows - tile is twice the halo, at least S*L*(K-1).  One cluster
// of `ranks` CTAs per time tile and batch row.  Returns the CUDA error of
// the launch (0 on success), -1 for a plan or column plan the kernel does
// not take.
extern "C" int coupling_block_bf16(const void* x, const int* lengths, const void* streams, const void* bp,
                                   const void* b_in, const void* g_all, const void* b_rs, const void* bq, void* out,
                                   const int* c_bounds, const int* h_bounds, const int* plan_table, int batch,
                                   int t_len, int chan, int hidden, int ksize, int n_layers, int n_steps, int rows,
                                   int tile, int skip_cols, int stages, int ranks, int device, void* stream) {
    int parts = 0;
    RingPlan plan;
    if (chan % 16 || hidden % 16 || rows % TILE_M || stages < 2 ||
        equal_share(c_bounds, h_bounds, ranks, parts) == 0 ||
        !make_plan(plan, plan_table, n_steps * (2 * n_layers + 2), rows, parts, WN_WARPGROUPS, stages, WN_GROUP))
        return -1;
    const int share = h_bounds[1] - h_bounds[0];
    const int unit_bytes = 32 * 8 * share;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = cluster_launch_config(
        cfg, attr, coupling_kernel, dim3(((t_len + tile - 1) / tile) * ranks, batch), WN_WARPGROUPS * 128,
        coupling_smem_bytes(chan, hidden, rows, skip_cols, unit_bytes, plan.ring_slabs, stages), ranks,
        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernelEx(&cfg, coupling_kernel, static_cast<const bf16*>(x), lengths,
                             static_cast<const unsigned char*>(streams),
                             static_cast<const bf16*>(bp), static_cast<const bf16*>(b_in),
                             static_cast<const bf16*>(g_all), static_cast<const bf16*>(b_rs),
                             static_cast<const bf16*>(bq), static_cast<bf16*>(out), t_len, chan, hidden, ksize,
                             n_layers, n_steps, rows, tile, share, skip_cols, parts, unit_bytes, plan);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
