// The thread-block-cluster machinery of the WaveNet kernels, shared by the
// WaveNet-stack kernel (wn.cu, K1) and the coupling-block kernel
// (coupling.cu, K2): the column plan, the cluster barrier, the push of
// finished tiles into the peers' shared memory, the tap product with its B
// fragments loaded ahead, and the WaveNet layer loop on a window held by every
// CTA of a cluster.
//
// The layer (openvoice_tpu/ops/wn_pallas.py::_wn_kernel):
//   x_in = sum_k xs[t + k - pad] @ W_in[k] + b_in + g        f32
//   acts = bf16(tanh(x_in[:, :H]) * sigmoid(x_in[:, H:]))
//   rs   = acts @ W_rs + b_rs                                  f32
//   xs   = bf16(xs + bf16(rs[:, :H])) * mask                   unless last layer
//   skip = skip + rs[:, H:]                                    f32
// and on the last layer the skip sum, rounded once and masked, is the
// WaveNet's output.
//
// The window holds `rows` consecutive frames; window row i is frame
// frame0 + i.  Rows whose frame lies outside [0, length) are held at zero at
// every layer (they are the convolution's zero padding and the padded part of
// a batch row).  Rows outside the window read as zero too, which is wrong for
// frames that exist, so rows near the window's edge go stale by `pad` rows a
// layer: the caller sizes the window's halo to the layers' reach and keeps
// only the rows in the middle.
//
// The split: each of the cluster's R CTAs keeps its own copy of the window
// and computes the output columns of its H-channel tiles [h0, h0 + nh)
// (ops/_frag.py::cluster_bounds), for the gate and res|skip products those
// channels of both halves (a gate pair's tanh and sigmoid columns, a
// channel's res and skip columns, stay with one warp).  A warp stores its
// finished tile into its own copy, then copies it into the peers' copies
// through distributed shared memory, 16 bytes a lane and row, and a cluster
// barrier (release / acquire) follows every product, so each product reads a
// complete local copy.  A read-modify-write reads the local copy and stores
// the same bits everywhere, so the copies stay identical.  The f32 skip sum
// holds the CTA's own channels only.

#pragma once

#include <cooperative_groups.h>

#include "mma_tile.cuh"

namespace ovt {

constexpr int MAX_RANKS = 8;  // the largest portable cluster
constexpr int B_AHEAD = 4;    // k-tiles of B fragments a warp loads ahead
// the ring of B fragments takes more registers than 512 threads leave a thread (128)
constexpr int MAX_THREADS = 384;

// The cluster's column plan: rank r owns C-column tiles [c[r], c[r + 1]) and
// H-channel tiles [h[r], h[r + 1]).
struct Split {
    int c[MAX_RANKS + 1];
    int h[MAX_RANKS + 1];
};

// Every thread of every CTA in the cluster arrives; the stores to shared
// memory (local and remote) made before it are seen by all after it.
__device__ __forceinline__ void cluster_barrier() {
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void store_pair(bf16* p, float v0, float v1) {
    *reinterpret_cast<bf162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// Copies the warp's finished tiles, rows row0 .. row0 + 32 of the 8-column
// tiles tiles[j] of buf (tiles[j] < 0: none), from this CTA's shared memory
// to the same place in every peer's: `mapa` finds the place in rank q's
// shared memory, and each lane stores one row of a tile, 16 bytes, there.
__device__ __forceinline__ void push_tiles(const bf16* buf, int ld, int row0, const int (&tiles)[NT], int ranks,
                                           int rank) {
    __syncwarp();  // the warp's own stores of the tiles first
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        if (tiles[j] < 0) continue;
        const bf16* p = buf + static_cast<size_t>(row0 + lane) * ld + tiles[j] * 8;
        const uint4 v = *reinterpret_cast<const uint4*>(p);
        const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
        for (int q = 0; q < ranks; ++q) {
            if (q == rank) continue;
            uint32_t remote;
            asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(q));
            asm volatile("st.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(remote), "r"(v.x), "r"(v.y),
                         "r"(v.z), "r"(v.w)
                         : "memory");
        }
    }
}

// acc += warp_gemm (mma_tile.cuh) over the n_taps taps of a convolution
// (tap i reads A from row row0 + i against W[i]; the taps' fragment words
// follow one another), with the B fragments loaded D = B_AHEAD k-tiles ahead
// in a ring of registers: the loads of step i + D are issued right after the
// products of step i, across tap boundaries.
__device__ __forceinline__ void warp_gemm_ahead(Acc& acc, const bf16* __restrict__ a, int lda, int a_rows,
                                                int row0, const bf16* __restrict__ zero_row, int cin,
                                                const uint2* __restrict__ wfrag, int n_taps, int n_tiles,
                                                const int (&nt)[NT]) {
    constexpr int D = B_AHEAD;
    const int lane = threadIdx.x & 31;
    const int lrow = lane & 15;
    const int lcol = (lane >> 4) * 8;
    const int k_tiles = cin >> 4, steps = n_taps * k_tiles;
    const size_t step_words = static_cast<size_t>(n_tiles) * 32;
    const uint2* wl = wfrag + lane;
    int loaded = 0;
    auto load = [&](uint2 (&dst)[NT]) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
            dst[j] = (loaded < steps && nt[j] >= 0) ? __ldg(wl + nt[j] * 32) : make_uint2(0u, 0u);
        ++loaded;
        wl += step_words;
    };
    const bf16* arow[MT];
    auto rows_of = [&](int tap) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            const int row = row0 + tap + mt * 16 + lrow;
            arow[mt] = (row >= 0 && row < a_rows) ? a + static_cast<size_t>(row) * lda + lcol : zero_row + lcol;
        }
    };
    uint2 b[D][NT];
#pragma unroll
    for (int d = 0; d < D; ++d) load(b[d]);
    int tap = 0, kt = 0;
    rows_of(0);
    for (int i0 = 0; i0 < steps; i0 += D) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
            if (i0 + d >= steps) break;
            uint32_t af[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(af[mt], arow[mt] + kt * 16);
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                if (nt[j] < 0) continue;
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) mma_16816(acc[mt][j], af[mt], b[d][j]);
            }
            load(b[d]);
            if (++kt == k_tiles) {
                kt = 0;
                rows_of(++tap);
            }
        }
    }
}

// A CTA's window and its share of the columns, for `wn_cluster_layers`.
struct WnShare {
    bf16* xs;              // [rows][ld] residual state
    bf16* acts;            // [rows][ld] gate output
    float* skip;           // [skip_rows][skip_ld]: the rank's skip channels of window rows skip_row0 ..
    const bf16* zero_row;  // at least H zeros
    int rows, ld, hidden, ksize;
    int skip_row0, skip_rows, skip_ld;
    int frame0, length;
    int h0, nh;            // the rank's H-channel tiles [h0, h0 + nh)
    int ranks, rank;
};

// The L layers of a WaveNet on a cluster's window: layers layer0 ..
// layer0 + L of w_in [.][K][H/16][2H/8][32] fragment words, b_in, b_rs
// [.][2H] bf16 and w_rs [.][H/16][2H/8][32] (the last layer's res half packed
// as zeros, and not computed), with conditioning rows g_row0 .. g_row0 + L of
// g_all [.][2H].  (Indices, not pointers to the first layer: the kernels'
// parameters stay where they are, and no pointer is held in registers across
// the loop.)  On the last
// layer the rank's finished skip values go to `sink(row, col, v0, v1)`
// (window row, H column of v0, the rounded-once pair still in f32, already
// masked) for the rows of the skip sum.  A sink with Sink::kIntoXs stores
// them into the same columns of xs, which are then pushed to the peers.  Two cluster barriers a layer, one after each
// product: the gate reads xs and writes acts, res|skip reads acts and writes
// xs, so each product reads one buffer and writes another.
template <class Sink>
__device__ __forceinline__ void wn_cluster_layers(const WnShare& w, const uint2* __restrict__ w_in,
                                                  const bf16* __restrict__ b_in, const bf16* __restrict__ g_all,
                                                  const uint2* __restrict__ w_rs, const bf16* __restrict__ b_rs,
                                                  int layer0, size_t g_row0, int n_layers, const Sink& sink) {
    const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5, lane = threadIdx.x & 31;
    const int hidden = w.hidden, h_tiles = hidden / 8, h0 = w.h0, nh = w.nh;
    const int m_chunks = w.rows / TILE_ROWS;
    const int pad = (w.ksize - 1) / 2;
    const size_t tap_words = static_cast<size_t>(hidden / 16) * (2 * h_tiles) * 32;
    const size_t in_words = static_cast<size_t>(w.ksize) * tap_words;
    auto live = [&](int row) { const int f = w.frame0 + row; return f >= 0 && f < w.length; };

    for (int l = 0; l < n_layers; ++l) {
        const bool first = l == 0, last = l == n_layers - 1;
        const size_t li = static_cast<size_t>(layer0) + l;
        const uint2* wl = w_in + li * in_words;
        const bf16* bl = b_in + li * 2 * hidden;
        const bf16* g = g_all + (g_row0 + l) * 2 * hidden;

        // dilated conv + gate: xs -> acts.  A warp tile pairs two of the
        // rank's tanh column tiles with the sigmoid tiles of the same channels.
        const int gate_groups = (nh + 1) / 2;
        for (int item = warp; item < m_chunks * gate_groups; item += n_warps) {
            const int gg = item / m_chunks, mc = item % m_chunks;
            const int ta = h0 + 2 * gg, tb = 2 * gg + 1 < nh ? ta + 1 : -1;
            const int nt[NT] = {ta, tb, h_tiles + ta, tb < 0 ? -1 : h_tiles + tb};
            Acc acc;
            zero_acc(acc);
            warp_gemm_ahead(acc, w.xs, w.ld, w.rows, mc * TILE_ROWS - pad, w.zero_row, hidden, wl, w.ksize,
                            2 * h_tiles, nt);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                if (nt[j] < 0) continue;
                const int col = nt[j] * 8 + (lane & 3) * 2;
                const float bt0 = __bfloat162float(bl[col]), bt1 = __bfloat162float(bl[col + 1]);
                const float bs0 = __bfloat162float(bl[hidden + col]), bs1 = __bfloat162float(bl[hidden + col + 1]);
                const float gt0 = __bfloat162float(g[col]), gt1 = __bfloat162float(g[col + 1]);
                const float gs0 = __bfloat162float(g[hidden + col]), gs1 = __bfloat162float(g[hidden + col + 1]);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        const int row = mc * TILE_ROWS + mt * 16 + (lane >> 2) + half * 8;
                        const float a0 = tanhf(acc[mt][j][2 * half] + bt0 + gt0) *
                                         sigmoidf_(acc[mt][j + 2][2 * half] + bs0 + gs0);
                        const float a1 = tanhf(acc[mt][j][2 * half + 1] + bt1 + gt1) *
                                         sigmoidf_(acc[mt][j + 2][2 * half + 1] + bs1 + gs1);
                        store_pair(w.acts + static_cast<size_t>(row) * w.ld + col, a0, a1);
                    }
            }
            push_tiles(w.acts, w.ld, mc * TILE_ROWS, {ta, tb, -1, -1}, w.ranks, w.rank);
        }
        cluster_barrier();

        // res|skip 1x1: acts -> the rank's residual channels of xs (not on
        // the last layer, whose res half is packed as zeros) and its skip sum
        const uint2* wr = w_rs + li * tap_words;
        const bf16* br = b_rs + li * 2 * hidden;
        const int n_own = last ? nh : 2 * nh;
        const int rs_groups = (n_own + NT - 1) / NT;
        for (int item = warp; item < m_chunks * rs_groups; item += n_warps) {
            const int gi = item / m_chunks, mc = item % m_chunks;
            int nt[NT];
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const int i = gi * NT + j;
                nt[j] = i >= n_own ? -1 : last ? h_tiles + h0 + i : i < nh ? h0 + i : h_tiles + h0 + i - nh;
            }
            Acc acc;
            zero_acc(acc);
            warp_gemm_ahead(acc, w.acts, w.ld, w.rows, mc * TILE_ROWS, w.zero_row, hidden, wr, 1, 2 * h_tiles, nt);
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                if (nt[j] < 0) continue;
                const int col = nt[j] * 8 + (lane & 3) * 2;
                const float b0 = __bfloat162float(br[col]), b1 = __bfloat162float(br[col + 1]);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        const int row = mc * TILE_ROWS + mt * 16 + (lane >> 2) + half * 8;
                        const float v0 = acc[mt][j][2 * half] + b0, v1 = acc[mt][j][2 * half + 1] + b1;
                        const bool ok = live(row);
                        if (col < hidden) {
                            bf16* px = w.xs + static_cast<size_t>(row) * w.ld + col;
                            const float2 cur = __bfloat1622float2(*reinterpret_cast<const bf162*>(px));
                            store_pair(px, ok ? cur.x + round_bf16(v0) : 0.f, ok ? cur.y + round_bf16(v1) : 0.f);
                            continue;
                        }
                        const int srow = row - w.skip_row0;
                        if (srow < 0 || srow >= w.skip_rows) continue;
                        float* ps = w.skip + static_cast<size_t>(srow) * w.skip_ld + (col - hidden - h0 * 8);
                        const float s0 = first ? v0 : ps[0] + v0, s1 = first ? v1 : ps[1] + v1;
                        if (last) {
                            // the WaveNet's output, rounded once (by the sink) and masked
                            sink(row, col - hidden, ok ? s0 : 0.f, ok ? s1 : 0.f);
                        } else {
                            ps[0] = s0;
                            ps[1] = s1;
                        }
                    }
            }
            // the res tiles, and on the last layer the finished skip tiles
            // when the sink stored them into xs, go to the peers
            int to_xs[NT];
#pragma unroll
            for (int j = 0; j < NT; ++j)
                to_xs[j] = nt[j] < 0 ? -1 : nt[j] < h_tiles ? nt[j] : last && Sink::kIntoXs ? nt[j] - h_tiles : -1;
            push_tiles(w.xs, w.ld, mc * TILE_ROWS, to_xs, w.ranks, w.rank);
        }
        cluster_barrier();
    }
}

// A cluster launch of `kernel`: grid, CTA size, shared memory (after raising
// the kernel's dynamic shared-memory limit to it) and R CTAs a cluster.
template <class Kernel>
cudaError_t cluster_launch_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, Kernel* kernel, dim3 grid,
                                  int threads, int smem, int ranks, cudaStream_t stream) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = ranks;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return cudaSuccess;
}

}  // namespace ovt
