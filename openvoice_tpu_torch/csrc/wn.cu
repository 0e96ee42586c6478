// K1: a whole L-layer WaveNet stack in one launch.
//
// Replaces the TPU kernel openvoice_tpu/ops/wn_pallas.py::fused_wn_stack
// (body _wn_kernel): per layer a K-tap conv H -> 2H off the residual, plus
// bias and that layer's conditioning slice, a tanh*sigmoid gate, a 1x1
// res|skip product, a masked residual update and an f32 skip sum; the output
// is the skip sum, rounded once and masked.  The rounding points are the
// Pallas body's (see wn_cluster.cuh).
//
// What bounds it: 2*T*L*(K+1)*H*2H operations (14.5 GFLOP at T=1024, L=16,
// K=5, H=192) against 14.9 MB of weights and under 1 MB of activations, so
// operations bound it, and the layers form one dependent chain of 2L
// products.  At B = 1 the chain's latency is what takes the time.
//
// Design: the TPU keeps all T frames of one batch row in fast memory; an SM
// cannot ([1024, 192] bf16 is 384 KiB against 227 KiB).  So time is cut into
// tiles, each with a recomputed halo of L*(K-1)/2 frames a side (the window
// goes stale by (K-1)/2 rows a layer from both edges and the rows in the
// middle stay exact), and each tile runs on a cluster of R CTAs
// (thread-block cluster) on R SMs, as K2 does (wn_cluster.cuh): every CTA
// keeps its own copy of the window's residual `xs` and gate output `acts` in
// bf16, computes a 1/R share of every product's output columns as wgmma
// products, its share of the weights streamed through a shared-memory ring
// in execution order (per layer the K taps of the gate, then res|skip), and
// pushes its finished rows into the peers' copies through distributed shared
// memory; one cluster barrier follows each product.  The f32 skip sum holds
// the CTA's own channels over the kept rows only; on the last layer the CTA
// rounds it once, masks it and stores it straight to `out` (no push).  A
// tile that starts at or past its row's length writes zeros and returns:
// every CTA of the cluster reads the same length and decides alike, before
// any cluster barrier, ring copy or remote store, and the grid stays the
// bucket's (the host never reads the lengths).

#include "wn_cluster.cuh"

using namespace ovt;
namespace cg = cooperative_groups;

namespace {

// The last layer's output, rounded once and masked, straight to the kept
// rows of `out`.
struct IntoOut {
    static constexpr bool kIntoXs = false;
    bf16* out;  // this batch row's [t_len][hidden]
    int frame0, t_len, hidden;
    __device__ __forceinline__ void operator()(int row, int col, float v0, float v1) const {
        const int frame = frame0 + row;
        if (frame < t_len) store_pair(out + static_cast<size_t>(frame) * hidden + col, v0, v1);
    }
};

__global__ void __launch_bounds__(WN_WARPGROUPS * 128, 1)
wn_stack_kernel(const bf16* __restrict__ x, const int* __restrict__ lengths,
                const unsigned char* __restrict__ streams, const bf16* __restrict__ b_in,
                const bf16* __restrict__ g_all, const bf16* __restrict__ b_rs, bf16* __restrict__ out,
                int t_len, int hidden, int ksize, int n_layers, int rows, int tile, int share, int skip_ld,
                int parts, int unit_bytes, RingPlan plan) {
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + (SLAB_ALIGN - smem_u32(smem_raw) % SLAB_ALIGN) % SLAB_ALIGN;
    const cg::cluster_group cluster = cg::this_cluster();
    const int ranks = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());

    const int b = blockIdx.y;
    const int halo = (rows - tile) / 2;
    const int t0 = static_cast<int>(blockIdx.x / ranks) * tile;
    const int frame0 = t0 - halo;
    const int length = min(lengths[b], t_len);
    const int tid = threadIdx.x, n_threads = blockDim.x;
    const int vec = hidden / 8;
    const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
    bf16* out_b = out + static_cast<size_t>(b) * t_len * hidden;

    if (t0 >= length) {
        // every frame of the tile lies past the length: the ranks share out
        // its zeros, and no CTA of the cluster has touched a peer
        for (int i = tid + rank * n_threads; i < tile * vec; i += n_threads * ranks) {
            const int frame = t0 + i / vec;
            if (frame < t_len)
                *reinterpret_cast<uint4*>(out_b + static_cast<size_t>(frame) * hidden + (i % vec) * 8) = zero4;
        }
        return;
    }

    Ring ring;
    const unsigned char* stream = streams + static_cast<size_t>(rank) * plan.slabs * unit_bytes;
    bf16* window = reinterpret_cast<bf16*>(ring_start<WN_WARPGROUPS, WN_GROUP>(ring, plan, smem, stream, unit_bytes));
    const int prows = chunk_rows(rows);
    const ChunkRows xs{window, prows};
    const ChunkRows acts{window + static_cast<size_t>(vec) * prows * 8, prows};
    float* skip = reinterpret_cast<float*>(window + 2 * static_cast<size_t>(vec) * prows * 8);  // [tile][skip_ld]

    // every CTA loads the whole window into its own copy, masked: frames
    // outside [0, length) are zero
    zero_pads(xs, hidden, rows);
    zero_pads(acts, hidden, rows);
    for (int i = tid; i < rows * vec; i += n_threads) {
        const int row = i / vec, c8 = (i % vec) * 8;
        const int frame = frame0 + row;
        uint4 v = zero4;
        if (frame >= 0 && frame < length)
            v = *reinterpret_cast<const uint4*>(x + (static_cast<size_t>(b) * t_len + frame) * hidden + c8);
        *reinterpret_cast<uint4*>(xs.at(row, c8)) = v;
    }
    // the first product waits on this barrier: no CTA stores into a peer's
    // shared memory before the peer runs
    cluster_arrive();

    const WnShare w{xs, acts, skip, hidden, ksize, halo, tile, skip_ld, frame0, length, rank * share, parts, ranks,
                    rank};
    wn_cluster_layers(w, ring, plan, 0, b_in, g_all, b_rs, 0, static_cast<size_t>(b) * n_layers, n_layers,
                      IntoOut{out_b, frame0, t_len, hidden});
    // after the last product's barrier no peer stores into this CTA's shared
    // memory, so it may exit
    cluster_wait();
}

}  // namespace

// Shared memory of one CTA, in bytes: the ring (room to align it, its
// `ring_units` units of `unit_bytes` in `stages` groups and their barriers),
// the bf16 window (xs and acts, ChunkRows) and the f32 skip sum of skip_cols
// channels over the tile's rows.
extern "C" int wn_stack_smem_bytes(int hidden, int rows, int tile, int skip_cols, int unit_bytes, int ring_units,
                                   int stages) {
    const long long bytes = cluster_ring_bytes(unit_bytes, ring_units, stages) + 2 * chunk_bytes(hidden, rows) +
                            1LL * tile * skip_cols * 4;
    return bytes > 0x7fffffff ? 0x7fffffff : static_cast<int>(bytes);
}

// Registers a thread and local (spilled) bytes of the kernel: out[0],
// out[1] (cudaFuncGetAttributes).  Returns the CUDA error (0 on success).
extern "C" int wn_stack_attributes(int* out) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, wn_stack_kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
    return 0;
}

// cudaOccupancyMaxActiveClusters for a launch with clusters of `ranks` CTAs
// and `smem` bytes a CTA: how many clusters the card holds at once (0: the
// launch cannot run).  Returns the CUDA error (0 on success), -1 for a
// cluster size the kernel does not take.
extern "C" int wn_stack_max_clusters(int smem, int ranks, int device, int* clusters) {
    if (ranks < 1 || ranks > MAX_RANKS) return -1;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = cluster_launch_config(cfg, attr, wn_stack_kernel, dim3(ranks), WN_WARPGROUPS * 128, smem, ranks, nullptr);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, wn_stack_kernel, &cfg));
}

// x, out [batch, t_len, hidden] bf16; lengths [batch] int32; streams [ranks]
// of each rank's weight stream (ops/_frag.py::cluster_streams), units of
// unit_bytes; b_in, b_rs [L][2H] bf16; g_all [batch][L][2H] bf16.  c_bounds,
// h_bounds: ranks + 1 tile boundaries each (the column plan; equal shares);
// skip_cols is 8 times a rank's H tiles.  plan [2L][PLAN_FIELDS]: each
// product's first row (0), 64-row tiles, units a round, first unit and ring
// groups so far (ops/_frag.py::ring_plan; `make_plan` checks it); stages
// (2 to MAX_STAGES) groups of WN_GROUP units.  hidden % 16 == 0; rows % 64 ==
// 0; rows - tile is twice the halo, at least L*(K-1).  One cluster of
// `ranks` CTAs per time tile and batch row.  Returns the CUDA error of the
// launch (0 on success), -1 for a plan or column plan the kernel does not
// take.
extern "C" int wn_stack_bf16(const void* x, const int* lengths, const void* streams, const void* b_in,
                             const void* g_all, const void* b_rs, void* out, const int* c_bounds,
                             const int* h_bounds, const int* plan_table, int batch, int t_len, int hidden, int ksize,
                             int n_layers, int rows, int tile, int skip_cols, int stages, int ranks, int device,
                             void* stream) {
    int parts = 0;
    RingPlan plan;
    if (hidden % 16 || rows % TILE_M || stages < 2 || equal_share(c_bounds, h_bounds, ranks, parts) == 0 ||
        !make_plan(plan, plan_table, 2 * n_layers, rows, parts, WN_WARPGROUPS, stages, WN_GROUP))
        return -1;
    const int share = h_bounds[1] - h_bounds[0];
    const int unit_bytes = 32 * 8 * share;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = cluster_launch_config(
        cfg, attr, wn_stack_kernel, dim3(((t_len + tile - 1) / tile) * ranks, batch), WN_WARPGROUPS * 128,
        wn_stack_smem_bytes(hidden, rows, tile, skip_cols, unit_bytes, plan.ring_slabs, stages), ranks,
        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernelEx(&cfg, wn_stack_kernel, static_cast<const bf16*>(x), lengths,
                             static_cast<const unsigned char*>(streams), static_cast<const bf16*>(b_in),
                             static_cast<const bf16*>(g_all), static_cast<const bf16*>(b_rs), static_cast<bf16*>(out),
                             t_len, hidden, ksize, n_layers, rows, tile, share, skip_cols, parts, unit_bytes, plan);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
