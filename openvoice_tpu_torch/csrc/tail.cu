// K4: a whole decoder stage with its upsample, in one launch.
//
// Replaces the TPU kernel openvoice_tpu/ops/mrf_pallas.py::fused_tail_stage
// (body _tail_kernel): leaky ReLU 0.1 -> ConvTranspose1d (kernel k_up, stride
// u, padding p with k_up = u + 2p, so T_out = T_in * u) -> mask -> the MRF
// stage of K3; on the last stage also leaky ReLU 0.01 -> conv_post (C -> 1,
// k_post taps, no bias) -> tanh, which gives the audio.
//
// The transposed convolution is y[t] = b + sum over (s, j) with s*u + j - p = t
// of x[s] @ W[j].  Output phase f = t mod u at output row m = t div u takes the
// taps j = j0 + i*u with j0 = (f + p) mod u, from input rows m + (f + p) div u
// - i.  So each phase is an ordinary row convolution of the input, whose
// results land on every u-th output row.
//
// Rounding points beyond the branches' (mrf_core.cuh): the upsample's output
// is rounded to bf16 after its bias and before the mask; the MRF mean is
// rounded before the last leaky ReLU; tanh takes the f32 sum of conv_post.
//
// Masks: the input is masked at pos_in < len_out div u, everything after the
// upsample at 0 <= pos < len_out.
//
// What bounds it: operations (142 GFLOP at T_out=131072, 128 -> 64 channels;
// 72 GFLOP at T_out=262144, 64 -> 32), against 2 bytes a channel a sample
// in and out: over 1000 operations a byte.
//
// Shared with K3 (mrf_core.cuh): the weight ring, the product loop and the
// branch loop.  K4's own: its window layout, the upsample's phases, conv_post
// and tanh, and the early exit.  One block per output time tile with a
// recomputed halo (the branches' 60 samples, plus conv_post's reach on the
// last stage).  The upsampled stage input cannot be read again from device
// memory, because it never exists there, so it gets a third shared-memory
// buffer; the staged input rows borrow the second conv's buffer, which is
// idle until the upsample has run.  The buffers are padded rows
// (`PaddedRows`), which ldmatrix reads without bank conflicts at every C.
// * Every product is a wgmma with N = C.  The upsample's phases are
//   convolutions over the staged input whose 64-row tiles are tiles of phase
//   rows; on the last stage the MRF convs' kept rows reach conv_post's half
//   width past the tile (ops/tail_cuda.py::tail_tiles).  The upsample fills
//   every window row, since each branch starts from the whole of it.
// * The stage's slabs are one stream in execution order (the upsample's
//   phases, then the MRF convs).  Where the whole stream fits beside the
//   window (C = 16: 66 KB) it stays resident; elsewhere it flows through the
//   ring in groups of 16 KB (8 slabs at C = 64, 16 at C = 32).
// What holds it on an H100 (PERF.md): the four warpgroups issue their
// products nearly in step (they share the ring's groups and meet at a block
// barrier after every conv), so the tensor cores wait while all of them run
// their epilogues, barriers and the last round of a conv that leaves some of
// them without a tile; clock counters put a block's time at C = 64 at about
// a quarter products, a sixth epilogues, a tenth barriers and a tenth idle
// warpgroups.
// * A tile whose first sample (less conv_post's reach on the last stage)
//   lies at or past the length writes its zeros and returns before staging
//   anything; the length is read on the device, so the launch does not
//   depend on it.
// conv_post has one output channel, so it runs as scalar f32 sums over the
// rounded activations, one output sample a thread.

#include "mrf_core.cuh"

using namespace ovt;

namespace {

constexpr int WARPGROUPS = 4;  // ops/tail_cuda.py::WARPGROUPS

// Slabs of a ring group (ops/tail_cuda.py::copy_group): 16 KB of weights,
// since one thread's bulk copies complete one after another, about as fast
// at any size up to 16 KB; 8 slabs at C = 64, 16 below.
__host__ __device__ constexpr int group_of(int chan) { return 16384 / (32 * chan) < MAX_GROUP ? 16384 / (32 * chan) : MAX_GROUP; }

// Element (row, col) of a window row lies at row * ld + col: rows padded by
// LD_PAD elements.  frag(row, kt, h): where the 8 columns kt * 16 + h * 8
// start.
struct PaddedRows {
    static __device__ __forceinline__ int col(int, int c) { return c; }
    static __device__ __forceinline__ int frag(int, int kt, int h) { return kt * 16 + h * 8; }
};

struct TailArgs {
    int t_in, cin, stride, pad_up, in_margin, k_post, rows, tile;
};

// Shared memory of one block, in bytes: room to align the slabs, the ring's
// (or the resident stream's) slabs and their barriers, a row of zeros, the
// window's three buffers (the third also holds the staged input) and the
// biases of the upsample and the n_convs MRF convs; 16-byte aligned
// throughout, as the bulk copies and ldmatrix ask.
__host__ __device__ __forceinline__ int smem_bytes(int cin, int chan, int stride, int in_margin, int rows,
                                                   int n_convs, int ring_slabs, int stages) {
    const int ld = chan + LD_PAD, ldin = cin + LD_PAD;
    const int in_rows = rows / stride + 2 * in_margin;
    const long long xt = (long long)rows * ld > (long long)in_rows * ldin ? (long long)rows * ld
                                                                            : (long long)in_rows * ldin;
    const long long bytes = SLAB_ALIGN + ring_bytes(32 * chan, ring_slabs, stages) +
                            2LL * ((ld > ldin ? ld : ldin) + 2LL * rows * ld + xt + (1LL + n_convs) * chan);
    return bytes > 0x7fffffff ? 0x7fffffff : static_cast<int>(bytes);
}

template <int N>
__global__ void __launch_bounds__(WARPGROUPS * 128, 1)
tail_stage_kernel(const bf16* __restrict__ x, const int* __restrict__ lengths,
                  const unsigned char* __restrict__ wslabs, const bf16* __restrict__ up_bias,
                  const bf16* __restrict__ bias, const bf16* __restrict__ post_w, bf16* __restrict__ out,
                  bf16* __restrict__ scratch, TailArgs a, MrfMeta meta, RingPlan plan) {
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    constexpr int chan = N;
    const int cin = a.cin, rows = a.rows, tile = a.tile, u = a.stride;
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

    // the weights start to flow before anything else
    unsigned char* smem = smem_raw + (SLAB_ALIGN - smem_u32(smem_raw) % SLAB_ALIGN) % SLAB_ALIGN;
    Ring ring;
    bf16* zero_row = reinterpret_cast<bf16*>(ring_start<WARPGROUPS, group_of(N)>(ring, plan, smem, wslabs, 32 * chan));

    const int ld = chan + LD_PAD, ldin = cin + LD_PAD;
    const int in_rows = rows / u + 2 * a.in_margin;
    const int ldz = max(ld, ldin);
    bf16* x0 = zero_row + ldz;
    bf16* xb = x0 + static_cast<size_t>(rows) * ld;
    bf16* xt = xb + static_cast<size_t>(rows) * ld;
    bf16* xin = xt;  // the staged input borrows xt until the upsample is done
    const int n_convs = 2 * meta.n_branches * meta.n_pairs;
    // the biases, read in every epilogue: the upsample's, then each conv's
    bf16* sbias = xt + (rows * ld > in_rows * ldin ? static_cast<size_t>(rows) * ld
                                                   : static_cast<size_t>(in_rows) * ldin);

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
    if (plan.stages == 0) mbar_wait(ring.bars, 0);  // the resident stream has landed
    __syncthreads();

    auto live = [&](int row) { const int p = pos0 + row; return p >= 0 && p < len_out; };
    // upsample, one output phase at a time, on every window row: phase row m
    // is window row m * u + f
    const int phase_rows = rows / u;
    for (int f = 0; f < u; ++f) {
        const int ds0 = (f + a.pad_up) / u;
        conv_wgmma<N, WARPGROUPS, group_of(N), false, PaddedRows>(
            xin, ldin, in_rows, cin / 16, zero_row, a.in_margin + ds0, -1, chan, sbias, no_slope(), ring, plan, f,
            [&](int m, int col, float v0, float v1) {
                if (m >= phase_rows) return;
                const int orow_ = m * u + f;
                const bool ok = live(orow_);
                *reinterpret_cast<bf162*>(x0 + static_cast<size_t>(orow_) * ld + col) =
                    __floats2bfloat162_rn(ok ? v0 : 0.f, ok ? v1 : 0.f);
            });
    }
    __syncthreads();

    MrfWindow w;
    w.xb = xb; w.xt = xt; w.zero_row = zero_row;
    w.parked = scratch + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * (meta.n_branches - 1) *
                             (tile + 2 * post_half) * chan;
    w.rows = rows; w.ld = ld; w.chan = chan;
    w.acc_row0 = halo - post_half; w.acc_rows = tile + 2 * post_half;
    w.pos0 = pos0; w.length = len_out;

    const float slope_post = __bfloat162float(__float2bfloat16_rn(0.01f));
    mrf_branches<N, WARPGROUPS, group_of(N), PaddedRows>(
        w, meta, plan, u, ring, sbias + chan,
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

// The kernel instance of a channel count, or null.
typedef void (*KernelFn)(const bf16*, const int*, const unsigned char*, const bf16*, const bf16*, const bf16*,
                         bf16*, bf16*, TailArgs, MrfMeta, RingPlan);

KernelFn kernel_for(int chan) {
    switch (chan) {
        case 16: return tail_stage_kernel<16>;
        case 32: return tail_stage_kernel<32>;
        case 64: return tail_stage_kernel<64>;
        default: return nullptr;
    }
}

}  // namespace

// Shared memory of one block, in bytes (smem_bytes above): ring_slabs slabs
// of 32 * chan bytes in `stages` groups, or the whole resident stream with
// stages = 0.
extern "C" int tail_stage_smem_bytes(int cin, int chan, int stride, int in_margin, int rows, int n_convs,
                                     int ring_slabs, int stages) {
    return smem_bytes(cin, chan, stride, in_margin, rows, n_convs, ring_slabs, stages);
}

// What the kernel instance of a channel count takes on the card: out[0]
// registers a thread, out[1] local memory a thread in bytes (spills), out[2]
// how many blocks of its threads and `smem` bytes an SM holds at once.
// Returns the CUDA error (0 on success), -1 for an instance that does not
// exist.
extern "C" int tail_stage_attributes(int chan, int smem, int device, int* out) {
    const KernelFn fn = kernel_for(chan);
    if (fn == nullptr) return -1;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, fn, WARPGROUPS * 128, smem));
}

// x [batch, t_in, cin] bf16; lengths [batch] int32 true OUTPUT sample counts;
// wslabs: the stage's weight stream, slabs of wgmma.cuh's B layout (32 * chan
// bytes each) in execution order: for each upsample phase f, its taps j =
// (f + pad_up) mod stride + i * stride (i = 0, 1, ...), each [cin/16]
// slabs of the transposed convolution's W[:, :, j]; then every MRF tap as
// mrf_stage_bf16's, [chan/16] slabs each (ops/tail_cuda.py::pack_stream);
// up_bias [chan]; bias [n_convs][chan]; ksizes [n_branches]; dilations
// [n_branches][n_pairs]; plan [stride + n_convs][PLAN_FIELDS]: each upsample
// phase (its tiles over the rows / stride phase rows), then each MRF conv
// (its tiles inside [0, rows)), as mrf_stage_bf16's (ops/mrf_cuda.py::
// ring_plan); post_w [k_post][chan] bf16 or null; scratch: batch *
// ceil(t_out / tile) * (n_branches - 1) * (tile + k_post - 1) * chan bf16
// (tile rows a block without post_w).  out is [batch, t_in * stride, chan]
// bf16 for a middle stage and [batch, t_in * stride] bf16 audio when post_w
// is given.  chan is 16, 32 or 64; cin % 16 == 0; stride up to 8; rows % 64
// == 0 and rows % stride == 0; the halo (rows - tile) / 2 and tile are
// multiples of stride.  stages: the ring's groups of `group` (group_of(chan))
// slabs, up to 32, or 0 for a resident stream (every slab in shared memory, a
// copy per 16 KB).  Returns the CUDA error of the launch (0 on success), -1
// for too many branches, pairs or phases, or a plan, ring or channel count
// the kernel cannot take.
extern "C" int tail_stage_bf16(const void* x, const int* lengths, const void* wslabs, const void* up_bias,
                               const void* bias, const void* post_w, void* out, void* scratch, int batch, int t_in,
                               int cin, int chan, int stride, int pad_up, int in_margin, int k_post,
                               int n_branches, int n_pairs, const int* ksizes, const int* dilations,
                               const int* plan_table, int rows, int tile, int stages, int group, int device,
                               void* stream) {
    if (n_branches < 1 || n_branches > MAX_BRANCHES || n_pairs < 1 || n_pairs > MAX_PAIRS) return -1;
    if (stride < 1 || stride > MAX_PHASES || cin % 16 || rows % TILE_M || rows % stride) return -1;
    const KernelFn fn = kernel_for(chan);
    const int n_convs = 2 * n_branches * n_pairs;
    RingPlan plan;
    if (fn == nullptr || group != group_of(chan) ||
        !make_plan(plan, plan_table, stride + n_convs, rows, 1, WARPGROUPS, stages, group))
        return -1;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int smem = smem_bytes(cin, chan, stride, in_margin, rows, n_convs, plan.ring_slabs, stages);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    TailArgs a;
    a.t_in = t_in; a.cin = cin; a.stride = stride; a.pad_up = pad_up;
    a.in_margin = in_margin; a.k_post = k_post; a.rows = rows; a.tile = tile;
    const int t_out = t_in * stride;
    const dim3 grid((t_out + tile - 1) / tile, batch);
    fn<<<grid, WARPGROUPS * 128, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), lengths, static_cast<const unsigned char*>(wslabs),
        static_cast<const bf16*>(up_bias), static_cast<const bf16*>(bias), static_cast<const bf16*>(post_w),
        static_cast<bf16*>(out), static_cast<bf16*>(scratch), a, make_meta(n_branches, n_pairs, ksizes, dilations),
        plan);
    return static_cast<int>(cudaGetLastError());
}
