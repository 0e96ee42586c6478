// The thread-block-cluster machinery of the WaveNet kernels, shared by the
// WaveNet-stack kernel (wn.cu, K1) and the coupling-block kernel
// (coupling.cu, K2): the window's layout, the cluster barrier, the push of
// finished rows into the peers' shared memory, the product of a CTA's
// columns on Hopper's warpgroup MMA with its weights streamed through the
// ring of ring.cuh, and the WaveNet layer loop on a window held by every CTA
// of a cluster.
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
// (ops/_frag.py::cluster_bounds; the kernels take equal shares, so h0 is
// rank * nh), for the gate and res|skip products those channels of both
// halves.  Each CTA's columns of every product are one stream of weight
// slabs in execution order (ops/_frag.py::cluster_streams), in wgmma's B
// layout: a gate pair's tanh and sigmoid tiles, and a channel's res and skip
// tiles, sit side by side, so that each epilogue finds both in one thread's
// accumulators.  A unit of the stream is one slab of a narrow product (pre,
// post, the last layer's skip: 8 nh columns, 256 nh bytes); a slab of a wide
// product (gate, res|skip) is two.  A product is one m64nNk16 wgmma a tap
// and k-tile for each item, a 64-row tile of the window by a 1/parts share
// of the CTA's columns (WN_WIDTH of a wide product), A and B both from
// shared memory: A from the window, which is held chunk by chunk
// (`ChunkRows`), so that a tap's row shift is an address, and B from the
// ring, whose copies run ahead of the products across their epilogues,
// pushes and cluster barriers.
//
// A warp stores its finished rows into its own copy, then copies them into
// the peers' copies through distributed shared memory, 16 bytes a lane and
// row, and a cluster barrier (release / acquire) follows every product, so
// each product reads a complete local copy.  A read-modify-write reads the
// local copy and stores the same bits everywhere, so the copies stay
// identical.  The f32 skip sum holds the CTA's own channels only.

#pragma once

#include <cooperative_groups.h>

#include "mma_tile.cuh"
#include "ring.cuh"
#include "wgmma.cuh"

namespace ovt {

constexpr int MAX_RANKS = 8;  // the largest portable cluster
// The one instance of K1 and K2 (ops/_frag.py::CLUSTER_WARPGROUPS,
// CLUSTER_WIDTH): four warpgroups a CTA, and items of 48 columns of a wide
// product (24 of a narrow one), half a CTA's at four CTAs and H = 192
constexpr int WN_WARPGROUPS = 4;
constexpr int WN_WIDTH = 48;
// A ring group of K1 and K2, in units of the stream: 4 wide slabs (12 KB at
// four CTAs and H = 192) or 8 narrow ones (ops/_frag.py::CLUSTER_GROUP)
constexpr int WN_GROUP = 8;
constexpr int PAD_ROWS = 4;   // zero rows before a window's first row (and one more after its last)
// Slabs of a batch of products (ops/_frag.py::CLUSTER_BATCH): every
// product's slabs, and a ring group's, are a multiple of it
constexpr int BATCH = 4;

// A bf16 window held chunk by chunk: for each 8-column chunk of its columns,
// all its rows one after another, 16 bytes a row, behind PAD_ROWS zero rows
// and ahead of PAD_ROWS + 1 (so that a conv's taps read zeros past the
// window's edges, and a chunk spans an odd number of rows: the same row of
// consecutive chunks falls on different banks).  wgmma reads a 64-row A tile
// of k-tile kt at any row r as the descriptor of chunk 2 kt, row r, with the
// next chunk LBO = 16 prows bytes on (wgmma.cuh::a_desc).
struct ChunkRows {
    bf16* base;
    int prows;  // rows a chunk: chunk_rows(rows)
    __device__ __forceinline__ bf16* at(int row, int col) const {
        return base + (static_cast<size_t>(col >> 3) * prows + row + PAD_ROWS) * 8 + (col & 7);
    }
};

__host__ __device__ __forceinline__ int chunk_rows(int rows) { return rows + 2 * PAD_ROWS + 1; }

// Zeroes the pad rows of the `cols` columns of w (every thread of the CTA
// calls it; no barrier inside).
__device__ __forceinline__ void zero_pads(const ChunkRows& w, int cols, int rows) {
    const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
    const int pads = 2 * PAD_ROWS + 1;
    for (int i = threadIdx.x; i < (cols / 8) * pads; i += blockDim.x) {
        const int chunk = i / pads, k = i % pads;
        const int row = k < PAD_ROWS ? k - PAD_ROWS : rows + k - PAD_ROWS;
        *reinterpret_cast<uint4*>(w.at(row, chunk * 8)) = zero4;
    }
}

// The cluster barrier in its two halves: every thread of every CTA in the
// cluster arrives, and once all have, the stores to shared memory (local and
// remote) each made before it arrived are seen by all after they wait.  A
// thread waits once for each arrival, before it arrives again.
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release;\n" ::: "memory"); }

__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory"); }

__device__ __forceinline__ void store_pair(bf16* p, float v0, float v1) {
    *reinterpret_cast<bf162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// Copies the warp's finished rows row0 .. row0 + 16 of the 8-column tiles
// tile0 .. tile0 + TILES of buf from this CTA's shared memory to the same
// place in every peer's: `mapa` finds the place in rank q's shared memory,
// and each lane stores one row of a tile, 16 bytes, there.
template <int TILES>
__device__ __forceinline__ void push_rows(const ChunkRows& buf, int row0, int tile0, int ranks, int rank) {
    constexpr int ITEMS = 16 * TILES;
    __syncwarp();  // the warp's own stores of the rows first
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < (ITEMS + 31) / 32; ++k) {
        const int i = lane + 32 * k;
        if (ITEMS % 32 && i >= ITEMS) break;
        const bf16* p = buf.at(row0 + (i & 15), (tile0 + (i >> 4)) * 8);
        const uint4 v = *reinterpret_cast<const uint4*>(p);
        const uint32_t addr = smem_u32(p);
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

// One product of the cluster loop, plan entry e: for each of the CTA's items
// (a 64-row tile's N-column part, `parts` parts to the CTA's columns)
//   acc[r, n] = sum_i A[r + shift0 + i, :] @ W_i[:, n]
// over the entry's taps i, k_tiles k-tiles a tap, on the window `a`, its
// slabs of U units from the ring in groups of WN_GROUP units.  Warpgroup w
// takes item w of each round of WN_WARPGROUPS, and a warpgroup without one
// walks the ring alone.  A group's products are issued back to back in
// batches of BATCH, A and B from shared memory, and run while the warpgroup
// waits for the next group: each group is released once the products of the
// group after it are issued and its own are done (wgmma_wait<1>), so two
// groups are in flight at most.
//
// The caller has arrived at the cluster barrier that follows the product
// before (every product reads what the one before wrote, in every CTA); the
// product waits on it once pre(part) has loaded its epilogue's constants
// and its first group is in, before its first read of the window.  The
// finished accumulators go to epi(acc, row0, part), row0 the first of the
// warp's 16 rows; the caller then arrives at the barrier after this product.
template <int N, int U, typename Pre, typename Epi>
__device__ __forceinline__ void cluster_product(const ChunkRows& a, int k_tiles, int shift0, int parts, Ring& ring,
                                                const RingPlan& plan, int e, Pre pre, Epi epi) {
    constexpr int G = WN_GROUP / U;  // slabs a group
    static_assert(WN_GROUP % (U * BATCH) == 0, "a ring group is whole batches");
    // the warpgroup, as a value the compiler knows is alike across the warp
    const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
    const int wrow = ((threadIdx.x >> 5) & 3) * 16;  // this warp's 16 rows of the tile
    const int first = plan.first[e], count = plan.count[e], steps = plan.steps[e] / U;  // slabs a round
    const int n_items = count * parts;
    const int slab_bytes = U * ring.slab_bytes;
    const uint32_t lbo = static_cast<uint32_t>(a.prows) * 16;  // one chunk to the next
    bool waited = false;
    for (int round0 = 0; round0 < n_items; round0 += WN_WARPGROUPS) {
        const int item = round0 + wg;
        if (item >= n_items) {
            if (!waited) cluster_wait();
            waited = true;
            for (int s = 0; s < steps; s += G) {
                ring_wait(ring, plan, e, s * U);
                ring_release(ring, plan, e);
            }
            continue;
        }
        const int part = item / count;
        const int row0 = first + (item - part * count) * TILE_M;
        const uint32_t a0 = smem_u32(a.at(row0 + shift0, 0));  // the tile at tap 0, k-tile 0
        const uint32_t b_off = static_cast<uint32_t>(part) * N * 32;
        pre(part);
        float acc[N / 2];
#pragma unroll
        for (int q = 0; q < N / 2; ++q) acc[q] = 0.f;
        int tap = 0, kt = 0;
        // BATCH slabs' products from `slab` on (tap, kt advance)
        auto batch = [&](uint32_t slab) {
#pragma unroll
            for (int q = 0; q < BATCH; ++q) {
                WgmmaSS<N>::mma(acc, a_desc(a0 + (tap + 2 * kt * a.prows) * 16, lbo), b_desc(slab + q * slab_bytes));
                if (++kt == k_tiles) {
                    kt = 0;
                    ++tap;
                }
            }
        };
        for (int s = 0; s < steps; s += G) {
            const uint32_t slab = ring_wait(ring, plan, e, s * U) + b_off;
            if (!waited) cluster_wait();
            waited = true;
            fence_acc(acc);
            wgmma_fence();
            // a group is whole batches: a product's slabs are a multiple of BATCH
#pragma unroll
            for (int q = 0; q < G; q += BATCH)
                if (q < steps - s) batch(slab + q * slab_bytes);
            wgmma_commit();
            if (s > 0) {
                wgmma_wait<1>();
                fence_acc(acc);
                ring_release(ring, plan, e);  // the group before
            }
        }
        wgmma_wait<0>();
        fence_acc(acc);
        ring_release(ring, plan, e);
        epi(acc, row0 + wrow, part);
    }
}

// A CTA's window and its share of the columns, for `wn_cluster_layers`.
struct WnShare {
    ChunkRows xs;          // [rows][H] residual state
    ChunkRows acts;        // [rows][H] gate output
    float* skip;           // [skip_rows][skip_ld]: the rank's skip channels of window rows skip_row0 ..
    int hidden, ksize;
    int skip_row0, skip_rows, skip_ld;
    int frame0, length;
    int h0, parts;         // the rank's first H-channel tile; items a 64-row tile
    int ranks, rank;
};

// The L layers of a WaveNet on a cluster's window: layers layer0 ..
// layer0 + L of b_in, b_rs [.][2H] bf16, with conditioning rows g_row0 ..
// g_row0 + L of g_all [.][2H], their products plan entries e0 .. e0 + 2L of
// the ring (the gate, then res|skip, a layer; the last layer's skip half
// alone, a narrow product).  (Indices, not pointers to the first layer: the
// kernels' parameters stay where they are, and no pointer is held in
// registers across the loop.)
// On the last layer the rank's finished skip values go to
// `sink(row, col, v0, v1)` (window row, H column of v0, the rounded-once
// pair still in f32, already masked) for the rows of the skip sum.  A sink
// with Sink::kIntoXs stores them into the same columns of xs, which are then
// pushed to the peers.  A cluster barrier after each product: the gate
// reads xs and writes acts, res|skip reads acts and writes xs, so each
// product reads one buffer and writes another.  The caller has arrived at
// the barrier before the first layer, and waits on the one after the last.
template <class Sink>
__device__ __forceinline__ void wn_cluster_layers(const WnShare& w, Ring& ring, const RingPlan& plan, int e0,
                                                  const bf16* __restrict__ b_in, const bf16* __restrict__ g_all,
                                                  const bf16* __restrict__ b_rs, int layer0, size_t g_row0,
                                                  int n_layers, const Sink& sink) {
    constexpr int NW = WN_WIDTH;
    constexpr int NP = NW / 16;  // channel tiles of an item
    const int lane = threadIdx.x & 31;
    const int hidden = w.hidden;
    const int pad = (w.ksize - 1) / 2;
    auto live = [&](int row) { const int f = w.frame0 + row; return f >= 0 && f < w.length; };
    // this thread's first column of channel tile ct0 + j, and a bf16 pair
    auto col_of = [&](int ct0, int j) { return (ct0 + j) * 8 + (lane & 3) * 2; };
    auto pair = [](const bf16* p) { return __bfloat1622float2(*reinterpret_cast<const bf162*>(p)); };

    for (int l = 0; l < n_layers; ++l) {
        const bool first = l == 0, last = l == n_layers - 1;
        const size_t li = static_cast<size_t>(layer0) + l;
        const bf16* bl = b_in + li * 2 * hidden;
        const bf16* g = g_all + (g_row0 + l) * 2 * hidden;
        const bf16* br = b_rs + li * 2 * hidden;

        // dilated conv + gate: xs -> acts.  Accumulator tiles 2j and 2j + 1
        // are the tanh and sigmoid columns of channel tile ct0 + j; their
        // biases and conditioning (tanh's, sigmoid's) load before the product.
        float2 cg[NP][4];
        cluster_product<NW, 2>(
            w.xs, hidden / 16, -pad, w.parts, ring, plan, e0 + 2 * l,
            [&](int part) {
#pragma unroll
                for (int j = 0; j < NP; ++j) {
                    const int col = col_of(w.h0 + part * NP, j);
                    cg[j][0] = pair(bl + col);
                    cg[j][1] = pair(bl + hidden + col);
                    cg[j][2] = pair(g + col);
                    cg[j][3] = pair(g + hidden + col);
                }
            },
            [&](float (&acc)[NW / 2], int row0, int part) {
                const int ct0 = w.h0 + part * NP;
#pragma unroll
                for (int j = 0; j < NP; ++j) {
                    const int col = col_of(ct0, j);
                    const float2 bt = cg[j][0], bs = cg[j][1], gt = cg[j][2], gs = cg[j][3];
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        const int row = row0 + (lane >> 2) + half * 8;
                        const int i = 8 * j + 2 * half;
                        const float a0 = tanhf(acc[i] + bt.x + gt.x) * sigmoidf_(acc[i + 4] + bs.x + gs.x);
                        const float a1 = tanhf(acc[i + 1] + bt.y + gt.y) * sigmoidf_(acc[i + 5] + bs.y + gs.y);
                        store_pair(w.acts.at(row, col), a0, a1);
                    }
                }
                push_rows<NP>(w.acts, row0, ct0, w.ranks, w.rank);
            });
        cluster_arrive();

        // res|skip 1x1: acts -> the rank's residual channels of xs and its
        // skip sum (on the last layer the skip half alone).  cr[j]: the res
        // and skip biases of channel tile ct0 + j, loaded before the product;
        // skip_pair takes the product's skip pair (v0, v1) of the tile's rows
        // `half`.
        float2 cr[NP][2];
        auto load_cr = [&](int part) {
#pragma unroll
            for (int j = 0; j < NP; ++j) {
                const int col = col_of(w.h0 + part * NP, j);
                cr[j][0] = pair(br + col);
                cr[j][1] = pair(br + hidden + col);
            }
        };
        auto skip_pair = [&](int row0, int ct0, int j, int half, float v0, float v1) {
            const int row = row0 + (lane >> 2) + half * 8;
            const int col = col_of(ct0, j);
            const int srow = row - w.skip_row0;
            if (srow < 0 || srow >= w.skip_rows) return;
            const float2 b = cr[j][1];
            float* ps = w.skip + static_cast<size_t>(srow) * w.skip_ld + (col - w.h0 * 8);
            const float s0 = first ? v0 + b.x : ps[0] + (v0 + b.x), s1 = first ? v1 + b.y : ps[1] + (v1 + b.y);
            if (last) {
                // the WaveNet's output, rounded once (by the sink) and masked
                const bool ok = live(row);
                sink(row, col, ok ? s0 : 0.f, ok ? s1 : 0.f);
            } else {
                ps[0] = s0;
                ps[1] = s1;
            }
        };
        if (!last) {
            // accumulator tiles 2j and 2j + 1: the res and skip columns of
            // channel tile ct0 + j
            cluster_product<NW, 2>(
                w.acts, hidden / 16, 0, w.parts, ring, plan, e0 + 2 * l + 1, load_cr,
                [&](float (&acc)[NW / 2], int row0, int part) {
                    const int ct0 = w.h0 + part * NP;
#pragma unroll
                    for (int j = 0; j < NP; ++j) {
                        const int col = col_of(ct0, j);
                        const float2 b = cr[j][0];
#pragma unroll
                        for (int half = 0; half < 2; ++half) {
                            const int row = row0 + (lane >> 2) + half * 8;
                            const int i = 8 * j + 2 * half;
                            const bool ok = live(row);
                            bf16* px = w.xs.at(row, col);
                            const float2 cur = pair(px);
                            store_pair(px, ok ? cur.x + round_bf16(acc[i] + b.x) : 0.f,
                                       ok ? cur.y + round_bf16(acc[i + 1] + b.y) : 0.f);
                            skip_pair(row0, ct0, j, half, acc[i + 4], acc[i + 5]);
                        }
                    }
                    push_rows<NP>(w.xs, row0, ct0, w.ranks, w.rank);
                });
        } else {
            // accumulator tile j: the skip columns of channel tile ct0 + j
            cluster_product<NW / 2, 1>(
                w.acts, hidden / 16, 0, w.parts, ring, plan, e0 + 2 * l + 1, load_cr,
                [&](float (&acc)[NW / 4], int row0, int part) {
                    const int ct0 = w.h0 + part * NP;
#pragma unroll
                    for (int j = 0; j < NP; ++j)
#pragma unroll
                        for (int half = 0; half < 2; ++half)
                            skip_pair(row0, ct0, j, half, acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
                    // the finished skip tiles, when the sink stored them into
                    // xs, go to the peers
                    if constexpr (Sink::kIntoXs) push_rows<NP>(w.xs, row0, ct0, w.ranks, w.rank);
                });
        }
        cluster_arrive();
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

// A CTA's share of the column plan from the host's boundaries (ranks + 1
// tile boundaries each of the C and H columns), if the kernels take it:
// equal shares, as many C tiles as H tiles, so that rank r owns tiles
// [r * share, (r + 1) * share) of both; and `parts`, the items of a 64-row
// tile, which split the share's columns of a wide product into items of
// WN_WIDTH.  Returns the share, 0 where the kernels do not take the plan.
inline int equal_share(const int* c_bounds, const int* h_bounds, int ranks, int& parts) {
    if (ranks < 1 || ranks > MAX_RANKS) return 0;
    const int share = h_bounds[1] - h_bounds[0];
    for (int r = 0; r <= ranks; ++r)
        if (c_bounds[r] != r * share || h_bounds[r] != r * share) return 0;
    parts = 16 * share / WN_WIDTH;
    return share > 0 && parts * WN_WIDTH == 16 * share ? share : 0;
}

// Shared memory of one CTA's ring, with room to align it.
inline long long cluster_ring_bytes(int unit_bytes, int ring_units, int stages) {
    return SLAB_ALIGN + ring_bytes(unit_bytes, ring_units, stages);
}

// Bytes of a window of `cols` columns and `rows` rows (ChunkRows).
inline long long chunk_bytes(int cols, int rows) { return 2LL * cols * chunk_rows(rows); }

}  // namespace ovt
