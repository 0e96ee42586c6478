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
// S=4, L=4, K=5, against 3.7 MB of weights), in one dependent chain of
// S*(L+2) products.  At B = 1 the chain's latency is what takes the time.
//
// Design: time tiles with a recomputed halo of S*L*(K-1)/2 frames a side,
// each tile on a cluster of R CTAs (thread-block cluster, R = 4 by default)
// on R SMs.  Every CTA keeps its own copy of the window's bf16 buffers (the
// [rows, C] state, the WaveNet's residual `hs` and gate output `acts`) and
// computes a 1/R share of every product's output columns, as the host's
// plan says (ops/_frag.py::cluster_bounds): rank r owns C-column
// tiles [c[r], c[r+1]) of the post product and H-channel tiles [h[r], h[r+1])
// of the pre, gate and res|skip products, for gate and res|skip those
// channels of both halves (a gate pair's tanh and sigmoid columns, a
// channel's res and skip columns, stay with one warp).  A warp stores its
// finished tile into its own copy, then copies it into the peers' copies
// through distributed shared memory, 16 bytes a lane and row, and a cluster
// barrier (release / acquire) follows every product, so each product reads a
// complete local copy.  A read-modify-write reads the local copy and stores
// the same bits everywhere, so the copies stay identical.  The f32 skip sum
// holds the CTA's own channels only; on the last layer it is final, and its
// rounded, masked value goes to `hs`, which the post product reads (the gate
// is the last reader of `hs` before it).  So one barrier per product: 2L + 2
// a step.  Each warp's chain of k-tiles waits on its B fragments from L2;
// the product loop loads them B_AHEAD k-tiles ahead (warp_gemm_ahead).

#include "wn_cluster.cuh"

using namespace ovt;
namespace cg = cooperative_groups;

namespace {

// The last WaveNet layer's output, rounded once and masked, goes into the
// same columns of hs: the post product's operand (the gate is the last
// reader of hs before it).
struct IntoHs {
    static constexpr bool kIntoXs = true;
    bf16* hs;
    int ld;
    __device__ __forceinline__ void operator()(int row, int col, float v0, float v1) const {
        store_pair(hs + static_cast<size_t>(row) * ld + col, v0, v1);
    }
};

__global__ void __launch_bounds__(MAX_THREADS, 1)
coupling_kernel(const bf16* __restrict__ x, const int* __restrict__ lengths,
                const uint2* __restrict__ wp, const bf16* __restrict__ bp,
                const uint2* __restrict__ w_in, const bf16* __restrict__ b_in,
                const bf16* __restrict__ g_all, const uint2* __restrict__ w_rs,
                const bf16* __restrict__ b_rs, const uint2* __restrict__ wq,
                const bf16* __restrict__ bq, bf16* __restrict__ out, int t_len, int chan, int hidden,
                int ksize, int n_layers, int n_steps, int rows, int tile, Split split, int skip_ld) {
    extern __shared__ __align__(16) unsigned char smem[];
    const cg::cluster_group cluster = cg::this_cluster();
    const int ranks = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int ldc = chan + LD_PAD, ldh = hidden + LD_PAD;
    const int ldz = max(ldc, ldh);
    bf16* zero_row = reinterpret_cast<bf16*>(smem);
    bf16* state = zero_row + ldz;
    bf16* hs = state + static_cast<size_t>(rows) * ldc;
    bf16* acts = hs + static_cast<size_t>(rows) * ldh;
    float* skip = reinterpret_cast<float*>(acts + static_cast<size_t>(rows) * ldh);  // [rows][skip_ld]

    const int b = blockIdx.y;
    const int halo = (rows - tile) / 2;
    const int t0 = static_cast<int>(blockIdx.x / ranks) * tile;
    const int frame0 = t0 - halo;
    const int length = min(lengths[b], t_len);
    const int tid = threadIdx.x, n_threads = blockDim.x;
    const int warp = tid >> 5, n_warps = n_threads >> 5, lane = tid & 31;
    const int m_chunks = rows / TILE_ROWS;
    const int h_tiles = hidden / 8, c_tiles = chan / 8;
    const int h0 = split.h[rank], nh = split.h[rank + 1] - h0;
    const int c0 = split.c[rank], nc = split.c[rank + 1] - c0;

    // every CTA loads the whole window into its own copy
    for (int i = tid; i < ldz; i += n_threads) zero_row[i] = __float2bfloat16_rn(0.f);
    const int vec = chan / 8;
    const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < rows * vec; i += n_threads) {
        const int row = i / vec, c8 = (i % vec) * 8;
        const int frame = frame0 + row;
        uint4 v = zero4;
        if (frame >= 0 && frame < length)
            v = *reinterpret_cast<const uint4*>(x + (static_cast<size_t>(b) * t_len + frame) * chan + c8);
        *reinterpret_cast<uint4*>(state + static_cast<size_t>(row) * ldc + c8) = v;
    }
    // also: no CTA stores into a peer's shared memory before the peer runs
    cluster_barrier();

    auto live = [&](int row) { const int f = frame0 + row; return f >= 0 && f < length; };
    const size_t pre_words = static_cast<size_t>(chan / 16) * h_tiles * 32;
    const size_t post_words = static_cast<size_t>(hidden / 16) * c_tiles * 32;

    for (int s = 0; s < n_steps; ++s) {
        // pre 1x1 (flip and half-select folded into the matrix): state -> hs
        const int pre_groups = (nh + NT - 1) / NT;
        for (int item = warp; item < m_chunks * pre_groups; item += n_warps) {
            const int gi = item / m_chunks, mc = item % m_chunks;
            int nt[NT];
#pragma unroll
            for (int j = 0; j < NT; ++j) nt[j] = gi * NT + j < nh ? h0 + gi * NT + j : -1;
            Acc acc;
            zero_acc(acc);
            warp_gemm_ahead(acc, state, ldc, rows, mc * TILE_ROWS, zero_row, chan, wp + s * pre_words, 1, h_tiles, nt);
            const bf16* bias = bp + s * hidden;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                if (nt[j] < 0) continue;
                const int col = nt[j] * 8 + (lane & 3) * 2;
                const float b0 = __bfloat162float(bias[col]), b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        const int row = mc * TILE_ROWS + mt * 16 + (lane >> 2) + half * 8;
                        const bool ok = live(row);
                        store_pair(hs + static_cast<size_t>(row) * ldh + col, ok ? acc[mt][j][2 * half] + b0 : 0.f,
                                   ok ? acc[mt][j][2 * half + 1] + b1 : 0.f);
                    }
            }
            push_tiles(hs, ldh, mc * TILE_ROWS, nt, ranks, rank);
        }
        cluster_barrier();

        const WnShare w{hs, acts, skip, zero_row, rows, ldh, hidden, ksize, 0, rows, skip_ld, frame0, length,
                        h0, nh, ranks, rank};
        wn_cluster_layers(w, w_in, b_in, g_all, w_rs, b_rs, s * n_layers,
                          (static_cast<size_t>(b) * n_steps + s) * n_layers, n_layers, IntoHs{hs, ldh});

        // post 1x1 (target half and sign folded in): hs -> the rank's state columns
        const int post_groups = (nc + NT - 1) / NT;
        for (int item = warp; item < m_chunks * post_groups; item += n_warps) {
            const int gi = item / m_chunks, mc = item % m_chunks;
            int nt[NT];
#pragma unroll
            for (int j = 0; j < NT; ++j) nt[j] = gi * NT + j < nc ? c0 + gi * NT + j : -1;
            Acc acc;
            zero_acc(acc);
            warp_gemm_ahead(acc, hs, ldh, rows, mc * TILE_ROWS, zero_row, hidden, wq + s * post_words, 1, c_tiles, nt);
            const bf16* bias = bq + s * chan;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                if (nt[j] < 0) continue;
                const int col = nt[j] * 8 + (lane & 3) * 2;
                const float b0 = __bfloat162float(bias[col]), b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        const int row = mc * TILE_ROWS + mt * 16 + (lane >> 2) + half * 8;
                        bf16* ps = state + static_cast<size_t>(row) * ldc + col;
                        const float2 cur = __bfloat1622float2(*reinterpret_cast<const bf162*>(ps));
                        const bool ok = live(row);
                        store_pair(ps, ok ? cur.x + round_bf16(acc[mt][j][2 * half] + b0) : 0.f,
                                   ok ? cur.y + round_bf16(acc[mt][j][2 * half + 1] + b1) : 0.f);
                    }
            }
            push_tiles(state, ldc, mc * TILE_ROWS, nt, ranks, rank);
        }
        // the last of these barriers is also the one every CTA passes before
        // it exits: after it no peer stores into its shared memory
        cluster_barrier();
    }

    // the copies are identical: the ranks share out the kept rows
    for (int i = tid + rank * n_threads; i < tile * vec; i += n_threads * ranks) {
        const int r = i / vec, c8 = (i % vec) * 8;
        const int frame = t0 + r;
        if (frame >= t_len) continue;
        *reinterpret_cast<uint4*>(out + (static_cast<size_t>(b) * t_len + frame) * chan + c8) =
            *reinterpret_cast<const uint4*>(state + static_cast<size_t>(halo + r) * ldc + c8);
    }
}

}  // namespace

// Shared memory of one CTA, in bytes: the bf16 window (state, hs, acts and a
// zero row) and the f32 skip sum of skip_cols channels.
extern "C" int coupling_smem_bytes(int chan, int hidden, int rows, int skip_cols) {
    const int ldc = chan + LD_PAD, ldh = hidden + LD_PAD;
    return ((ldc > ldh ? ldc : ldh) + rows * ldc + 2 * rows * ldh) * 2 + rows * skip_cols * 4;
}

// cudaOccupancyMaxActiveClusters for a launch of `threads` threads a CTA and
// clusters of `ranks` CTAs: how many clusters the card holds at once (0: the
// launch cannot run).  Returns the CUDA error (0 on success).
extern "C" int coupling_max_clusters(int chan, int hidden, int rows, int skip_cols, int threads, int ranks,
                                     int device, int* clusters) {
    if (threads > MAX_THREADS || ranks < 1 || ranks > MAX_RANKS)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = cluster_launch_config(cfg, attr, coupling_kernel, dim3(ranks), threads,
                                coupling_smem_bytes(chan, hidden, rows, skip_cols), ranks, nullptr);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, coupling_kernel, &cfg));
}

// x, out [batch, t_len, chan] bf16; lengths [batch] int32; per step s: wp
// [S][C/16][H/8][32] fragment words, bp [S][H], w_in [S][L][K][H/16][2H/8][32],
// b_in, b_rs [S][L][2H], w_rs [S][L][H/16][2H/8][32], wq [S][H/16][C/8][32],
// bq [S][C]; g_all [batch][S][L][2H].  c_bounds, h_bounds: ranks + 1 tile
// boundaries each (the column plan); skip_cols is 8 times the most H tiles a
// rank owns.  chan % 16 == hidden % 16 == 0; rows % 32 == 0; rows - tile is
// twice the halo, at least S*L*(K-1); 1 <= ranks <= 8; threads at most
// 384.  One cluster of `ranks` CTAs per time tile
// and batch row.  Returns the CUDA error of the launch (0 on success).
extern "C" int coupling_block_bf16(const void* x, const int* lengths, const void* wp, const void* bp,
                                   const void* w_in, const void* b_in, const void* g_all,
                                   const void* w_rs, const void* b_rs, const void* wq, const void* bq,
                                   void* out, const int* c_bounds, const int* h_bounds, int batch, int t_len,
                                   int chan, int hidden, int ksize, int n_layers, int n_steps, int rows,
                                   int tile, int skip_cols, int threads, int ranks, int device,
                                   void* stream) {
    if (threads > MAX_THREADS || ranks < 1 || ranks > MAX_RANKS)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    Split split{};
    for (int r = 0; r <= ranks; ++r) {
        split.c[r] = c_bounds[r];
        split.h[r] = h_bounds[r];
    }
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = cluster_launch_config(cfg, attr, coupling_kernel, dim3(((t_len + tile - 1) / tile) * ranks, batch),
                                threads, coupling_smem_bytes(chan, hidden, rows, skip_cols), ranks,
                                static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernelEx(&cfg, coupling_kernel, static_cast<const bf16*>(x), lengths, static_cast<const uint2*>(wp),
                             static_cast<const bf16*>(bp), static_cast<const uint2*>(w_in),
                             static_cast<const bf16*>(b_in), static_cast<const bf16*>(g_all),
                             static_cast<const uint2*>(w_rs), static_cast<const bf16*>(b_rs),
                             static_cast<const uint2*>(wq), static_cast<const bf16*>(bq), static_cast<bf16*>(out),
                             t_len, chan, hidden, ksize, n_layers, n_steps, rows, tile, split, skip_cols);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
