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
// in device memory for the last branch, as in K3.
// * Each conv computes only the 16-row chunks that the convs after it in its
//   branch still read (the host's plan, ops/tail_cuda.py::tail_chunks, as
//   K3's ops/mrf_cuda.py::conv_chunks); on the last stage the kept rows
//   reach conv_post's half width past the tile.  Rows outside a conv's
//   chunks are not written and hold stale values that only rows outside the
//   next conv's chunks read.  The upsample fills every window row, since
//   each branch starts from the whole of it.
// * Every product runs tap by tap through mma_tile.cuh::warp_gemm, with B
//   from L2 at each k-tile.  Loading B a few k-tiles ahead in a ring of
//   registers across taps, as K2 does, was slower here (PERF.md).
// * A tile whose first sample (less conv_post's reach on the last stage)
//   lies at or past the length writes its zeros and returns before staging
//   anything; the length is read on the device, so the launch does not
//   depend on it.
// * The window's size is a knob of the wrapper: at the converter's lengths
//   the largest windows leave a last wave nearly empty.
// On an H100 one block alone takes as long as a wave of the grid: what holds
// the kernel is each block's own chain of mma.sync steps, epilogues and
// barriers, not L2 (PERF.md).  conv_post has one output channel, so it runs
// as scalar f32 sums over the rounded activations, one output sample a
// thread.

#include "mrf_branch.cuh"

using namespace ovt;

namespace {

constexpr int MAX_CONVS = MAX_BRANCHES * MAX_PAIRS * 2;
constexpr int CHUNK_ROWS = 16;  // the row granularity of a conv's range: one m16 tile
constexpr int MAX_THREADS = 512;

// The window rows each MRF conv computes, in execution order: chunks
// [first, first + count) of CHUNK_ROWS rows; count is even (a warp tile is
// two chunks).
struct ConvChunks {
    int first[MAX_CONVS], count[MAX_CONVS];
};

struct TailArgs {
    int t_in, cin, chan, stride, k_up, pad_up, in_margin, k_post, rows, tile;
};

// A block-wide convolution over the output rows of chunks [c0, c0 + 2 *
// m_tiles) and columns n in [0, n_out):
//   y[r, n] = bias[n] + sum_i A[a_row0 + r + shift0 + i * shift_step, :] @ W_i[:, n]
// W_i is tap i's [cin/16][n_out/8][32] fragment matrix at wfrag + i *
// tap_stride words, each tap one warp_gemm (mma_tile.cuh), with the bf16 leaky
// ReLU on A when LRELU; bias in shared memory.  The block's warps share the
// 32 x 32 tiles; each element pair (r, n), (r, n + 1) goes once through
// store(r, n, y0, y1).  No barrier inside.
template <bool LRELU, typename Store>
__device__ __forceinline__ void block_conv(const bf16* a, int lda, int a_rows, int a_row0, int c0, int m_tiles,
                                           int cin, const bf16* zero_row, const uint2* __restrict__ wfrag,
                                           size_t tap_stride, int n_out, int n_taps, int shift0, int shift_step,
                                           const bf16* bias, bf162 slope, Store store) {
    const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5, lane = threadIdx.x & 31;
    const int n_tiles = n_out >> 3, n_groups = (n_tiles + NT - 1) / NT;
    // neighbouring warps take the same columns of neighbouring row tiles, so
    // they read the same weight lines at about the same time
    for (int item = warp; item < m_tiles * n_groups; item += n_warps) {
        const int ng = item / m_tiles;
        const int row0 = c0 * CHUNK_ROWS + (item % m_tiles) * TILE_ROWS;
        int nt[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j) nt[j] = (ng * NT + j < n_tiles) ? ng * NT + j : -1;
        Acc acc;
        zero_acc(acc);
        for (int i = 0; i < n_taps; ++i)
            warp_gemm<LRELU>(acc, a, lda, a_rows, a_row0 + row0 + shift0 + i * shift_step, zero_row, cin,
                             wfrag + i * tap_stride, n_tiles, nt, slope);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            if (nt[j] < 0) continue;
            const int col = nt[j] * 8 + (lane & 3) * 2;
            const float2 bc = __bfloat1622float2(*reinterpret_cast<const bf162*>(bias + col));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int half = 0; half < 2; ++half)
                    store(row0 + mt * 16 + (lane >> 2) + half * 8, col, acc[mt][j][2 * half] + bc.x,
                          acc[mt][j][2 * half + 1] + bc.y);
        }
    }
}

// The branch chains of mrf_branch.cuh on the window, each conv on its own
// chunks.  wfrag: every conv's taps in execution order, each tap a
// [C/16][C/8][32] fragment matrix; bias [n_convs][C] in shared memory.
// load_x0() fills w.xb with the masked stage input (every thread calls it; no
// barrier needed inside).  result(row, col, m0, m1) receives the stage's
// result for rows acc_row0 .. acc_row0 + acc_rows, once per element pair.
// Ends with a barrier.
template <typename LoadX0, typename Result>
__device__ __forceinline__ void tail_branches(const MrfWindow& w, const MrfMeta& meta, const ConvChunks& chunks,
                                              const uint2* __restrict__ wfrag, const bf16* bias,
                                              LoadX0 load_x0, Result result) {
    const int c = w.chan;
    const size_t tap_words = static_cast<size_t>(c >> 4) * (c >> 3) * 32;
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
            block_conv<true>(w.xb, w.ld, w.rows, 0, chunks.first[cv], chunks.count[cv] / MT, c, w.zero_row, wfrag,
                             tap_words, c, k, -half * d, d, bias, slope, [&](int row, int col, float v0, float v1) {
                                 const bool ok = live(row);
                                 const float a0 = ok ? lrelu_bf16(round_bf16(v0), slope_f) : 0.f;
                                 const float a1 = ok ? lrelu_bf16(round_bf16(v1), slope_f) : 0.f;
                                 *reinterpret_cast<bf162*>(w.xt + static_cast<size_t>(row) * w.ld + col) =
                                     __floats2bfloat162_rn(a0, a1);
                             });
            wfrag += k * tap_words;
            bias += c;
            __syncthreads();
            const bool last_pair = pair == meta.n_pairs - 1;
            block_conv<false>(
                w.xt, w.ld, w.rows, 0, chunks.first[cv + 1], chunks.count[cv + 1] / MT, c, w.zero_row, wfrag,
                tap_words, c, k, -half, 1, bias, slope, [&](int row, int col, float v0, float v1) {
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
            wfrag += k * tap_words;
            bias += c;
            __syncthreads();
        }
    }
}

__global__ void __launch_bounds__(MAX_THREADS, 1)
tail_stage_kernel(const bf16* __restrict__ x, const int* __restrict__ lengths,
                  const uint2* __restrict__ up_frag, const bf16* __restrict__ up_bias,
                  const uint2* __restrict__ wfrag, const bf16* __restrict__ bias,
                  const bf16* __restrict__ post_w, bf16* __restrict__ out, bf16* __restrict__ scratch,
                  TailArgs a, MrfMeta meta, ConvChunks chunks) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int chan = a.chan, cin = a.cin, rows = a.rows, tile = a.tile, u = a.stride;
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

    const int ld = chan + LD_PAD, ldin = cin + LD_PAD;
    const int in_rows = rows / u + 2 * a.in_margin;
    const int ldz = max(ld, ldin);
    bf16* zero_row = reinterpret_cast<bf16*>(smem);
    bf16* x0 = zero_row + ldz;
    bf16* xb = x0 + static_cast<size_t>(rows) * ld;
    bf16* xt = xb + static_cast<size_t>(rows) * ld;
    bf16* xin = xt;  // the staged input borrows xt until the upsample is done
    const int n_convs = 2 * meta.n_branches * meta.n_pairs;
    // the biases, read in every epilogue: the upsample's, then each conv's
    bf16* sbias = xt + (rows * ld > in_rows * ldin ? static_cast<size_t>(rows) * ld
                                                   : static_cast<size_t>(in_rows) * ldin);

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
    __syncthreads();

    auto live = [&](int row) { const int p = pos0 + row; return p >= 0 && p < len_out; };
    // upsample, one output phase at a time, on every window row
    const size_t up_tap_words = static_cast<size_t>(cin >> 4) * (chan >> 3) * 32;
    for (int f = 0; f < u; ++f) {
        const int j0 = (f + a.pad_up) % u;
        const int ds0 = (f + a.pad_up) / u;
        const int n_taps = (a.k_up - j0 + u - 1) / u;
        block_conv<false>(xin, ldin, in_rows, a.in_margin, 0, (rows / u) / TILE_ROWS, cin, zero_row,
                          up_frag + j0 * up_tap_words, u * up_tap_words, chan, n_taps, ds0, -1, sbias, no_slope(),
                          [&](int row, int col, float v0, float v1) {
                              const int orow_ = row * u + f;
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
    tail_branches(
        w, meta, chunks, wfrag, sbias + chan,
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

}  // namespace

// Shared memory of one block, in bytes: a row of zeros, the window's three
// buffers (the third also holds the staged input) and the biases of the
// upsample and the n_convs MRF convs.
extern "C" int tail_stage_smem_bytes(int cin, int chan, int stride, int in_margin, int rows, int n_convs) {
    const int ld = chan + LD_PAD, ldin = cin + LD_PAD;
    const int in_rows = rows / stride + 2 * in_margin;
    const long long xt = (long long)rows * ld > (long long)in_rows * ldin ? (long long)rows * ld
                                                                            : (long long)in_rows * ldin;
    return static_cast<int>(((ld > ldin ? ld : ldin) + 2LL * rows * ld + xt + (1LL + n_convs) * chan) * 2);
}

// What the kernel takes on the card: registers a thread, local memory a
// thread in bytes (spills), and how many blocks of `threads` threads and
// `smem` bytes an SM holds at once.  Returns the CUDA error (0 on success).
extern "C" int tail_stage_attributes(int threads, int smem, int device, int* regs, int* local_bytes,
                                     int* blocks_per_sm) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, tail_stage_kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    *regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    err = cudaFuncSetAttribute(tail_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, tail_stage_kernel, threads, smem));
}

// x [batch, t_in, cin] bf16; lengths [batch] int32 true OUTPUT sample counts;
// up_frag [k_up][cin/16][chan/8][32] fragment words (tap j is the transposed
// convolution's W[:, :, j]); up_bias [chan]; wfrag, bias, ksizes, dilations as
// mrf_stage_bf16; chunks [n_convs][2]: each MRF conv's first 16-row chunk of
// the window and its even, nonzero chunk count, inside [0, rows / 16);
// post_w [k_post][chan] bf16 or null; scratch: batch * ceil(t_out / tile) *
// (n_branches - 1) * (tile + k_post - 1) * chan bf16 (tile rows a block
// without post_w).  out is [batch, t_in * stride, chan] bf16 for a middle
// stage and [batch, t_in * stride] bf16 audio when post_w is given.
// cin % 16 == chan % 16 == 0; rows % (32 * stride) == 0; tile and the halo
// (rows - tile) / 2 are multiples of stride; threads a multiple of 32 up to
// 512.  Returns the CUDA error of the launch (0 on success), -1 for too many
// branches or pairs, a bad chunk range, or a thread count the kernel cannot
// take.
extern "C" int tail_stage_bf16(const void* x, const int* lengths, const void* up_frag,
                               const void* up_bias, const void* wfrag, const void* bias,
                               const void* post_w, void* out, void* scratch, int batch, int t_in, int cin, int chan,
                               int stride, int k_up, int pad_up, int in_margin, int k_post,
                               int n_branches, int n_pairs, const int* ksizes, const int* dilations,
                               const int* chunks, int rows, int tile, int threads, int device, void* stream) {
    if (n_branches < 1 || n_branches > MAX_BRANCHES || n_pairs < 1 || n_pairs > MAX_PAIRS) return -1;
    if (threads < 32 || threads > MAX_THREADS || threads % 32) return -1;
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
    const int smem = tail_stage_smem_bytes(cin, chan, stride, in_margin, rows, 2 * n_branches * n_pairs);
    err = cudaFuncSetAttribute(tail_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    TailArgs a;
    a.t_in = t_in; a.cin = cin; a.chan = chan; a.stride = stride; a.k_up = k_up; a.pad_up = pad_up;
    a.in_margin = in_margin; a.k_post = k_post; a.rows = rows; a.tile = tile;
    const int t_out = t_in * stride;
    const dim3 grid((t_out + tile - 1) / tile, batch);
    tail_stage_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), lengths, static_cast<const uint2*>(up_frag),
        static_cast<const bf16*>(up_bias), static_cast<const uint2*>(wfrag),
        static_cast<const bf16*>(bias), static_cast<const bf16*>(post_w), static_cast<bf16*>(out),
        static_cast<bf16*>(scratch), a, make_meta(n_branches, n_pairs, ksizes, dilations), cc);
    return static_cast<int>(cudaGetLastError());
}
