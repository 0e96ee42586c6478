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
// (thread-block cluster, R = 4 by default) on R SMs, as K2 does
// (wn_cluster.cuh): every CTA keeps its own copy of the window's residual
// `xs` and gate output `acts` in bf16, computes a 1/R share of every
// product's output columns, and pushes each finished tile into the peers'
// copies through distributed shared memory; one cluster barrier follows each
// product.  So each CTA reads a 1/R share of the weights, and the chain's
// products are R times narrower.  The f32 skip sum holds the CTA's own
// channels over the kept rows only; on the last layer the CTA rounds it once,
// masks it and stores it straight to `out` (no push).  B fragments are
// loaded B_AHEAD k-tiles ahead (warp_gemm_ahead).  A tile that starts at or
// past its row's length writes zeros and returns: every CTA of the cluster
// reads the same length and decides alike, before any cluster barrier or
// remote store, and the grid stays the bucket's (the host never reads the
// lengths).

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

__global__ void __launch_bounds__(MAX_THREADS, 1)
wn_stack_kernel(const bf16* __restrict__ x, const int* __restrict__ lengths,
                const uint2* __restrict__ w_in, const bf16* __restrict__ b_in,
                const bf16* __restrict__ g_all, const uint2* __restrict__ w_rs,
                const bf16* __restrict__ b_rs, bf16* __restrict__ out, int t_len, int hidden,
                int ksize, int n_layers, int rows, int tile, Split split, int skip_ld) {
    extern __shared__ __align__(16) unsigned char smem[];
    const cg::cluster_group cluster = cg::this_cluster();
    const int ranks = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int ld = hidden + LD_PAD;
    bf16* zero_row = reinterpret_cast<bf16*>(smem);
    bf16* xs = zero_row + ld;
    bf16* acts = xs + static_cast<size_t>(rows) * ld;
    float* skip = reinterpret_cast<float*>(acts + static_cast<size_t>(rows) * ld);  // [tile][skip_ld]

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

    // every CTA loads the whole window into its own copy, masked: frames
    // outside [0, length) are zero
    for (int i = tid; i < ld; i += n_threads) zero_row[i] = __float2bfloat16_rn(0.f);
    for (int i = tid; i < rows * vec; i += n_threads) {
        const int row = i / vec, c8 = (i % vec) * 8;
        const int frame = frame0 + row;
        uint4 v = zero4;
        if (frame >= 0 && frame < length)
            v = *reinterpret_cast<const uint4*>(x + (static_cast<size_t>(b) * t_len + frame) * hidden + c8);
        *reinterpret_cast<uint4*>(xs + static_cast<size_t>(row) * ld + c8) = v;
    }
    // also: no CTA stores into a peer's shared memory before the peer runs
    cluster_barrier();

    const int h0 = split.h[rank], nh = split.h[rank + 1] - h0;
    const WnShare w{xs, acts, skip, zero_row, rows, ld, hidden, ksize, halo, tile, skip_ld, frame0, length,
                    h0, nh, ranks, rank};
    // the layer loop ends with a cluster barrier: after it no peer stores
    // into this CTA's shared memory, so it may exit
    wn_cluster_layers(w, w_in, b_in, g_all, w_rs, b_rs, 0, static_cast<size_t>(b) * n_layers, n_layers,
                      IntoOut{out_b, frame0, t_len, hidden});
}

}  // namespace

// Shared memory of one CTA, in bytes: the bf16 window (xs, acts and a zero
// row) and the f32 skip sum of skip_cols channels over the tile's rows.
extern "C" int wn_stack_smem_bytes(int hidden, int rows, int tile, int skip_cols) {
    const int ld = hidden + LD_PAD;
    return (1 + 2 * rows) * ld * 2 + tile * skip_cols * 4;
}

// Registers and local (spilled) bytes a thread of the kernel, as ptxas left
// them (cudaFuncGetAttributes).  Returns the CUDA error (0 on success).
extern "C" int wn_stack_attributes(int device, int* regs, int* local_bytes) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, wn_stack_kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    *regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    return 0;
}

// cudaOccupancyMaxActiveClusters for a launch of `threads` threads a CTA and
// clusters of `ranks` CTAs: how many clusters the card holds at once (0: the
// launch cannot run).  Returns the CUDA error (0 on success).
extern "C" int wn_stack_max_clusters(int hidden, int rows, int tile, int skip_cols, int threads, int ranks,
                                     int device, int* clusters) {
    if (threads > MAX_THREADS || ranks < 1 || ranks > MAX_RANKS)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = cluster_launch_config(cfg, attr, wn_stack_kernel, dim3(ranks), threads,
                                wn_stack_smem_bytes(hidden, rows, tile, skip_cols), ranks, nullptr);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, wn_stack_kernel, &cfg));
}

// x, out [batch, t_len, hidden] bf16; lengths [batch] int32; w_in
// [L][K][H/16][2H/8][32] 8-byte fragment words; b_in, b_rs [L][2H] bf16; g_all
// [batch][L][2H] bf16; w_rs [L][H/16][2H/8][32].  h_bounds: ranks + 1 tile
// boundaries (the column plan); skip_cols is 8 times the most H tiles a rank
// owns.  hidden % 16 == 0; rows % 32 == 0; rows - tile is twice the halo, at
// least L*(K-1); 1 <= ranks <= 8; threads at most 384.  One cluster of
// `ranks` CTAs per time tile and batch row.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int wn_stack_bf16(const void* x, const int* lengths, const void* w_in, const void* b_in,
                             const void* g_all, const void* w_rs, const void* b_rs, void* out,
                             const int* h_bounds, int batch, int t_len, int hidden, int ksize, int n_layers,
                             int rows, int tile, int skip_cols, int threads, int ranks, int device,
                             void* stream) {
    if (threads > MAX_THREADS || ranks < 1 || ranks > MAX_RANKS)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    Split split{};
    for (int r = 0; r <= ranks; ++r) split.h[r] = h_bounds[r];
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = cluster_launch_config(cfg, attr, wn_stack_kernel, dim3(((t_len + tile - 1) / tile) * ranks, batch),
                                threads, wn_stack_smem_bytes(hidden, rows, tile, skip_cols), ranks,
                                static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernelEx(&cfg, wn_stack_kernel, static_cast<const bf16*>(x), lengths,
                             static_cast<const uint2*>(w_in), static_cast<const bf16*>(b_in),
                             static_cast<const bf16*>(g_all), static_cast<const uint2*>(w_rs),
                             static_cast<const bf16*>(b_rs), static_cast<bf16*>(out), t_len, hidden, ksize,
                             n_layers, rows, tile, split, skip_cols);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
