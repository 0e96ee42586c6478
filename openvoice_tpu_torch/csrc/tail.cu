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
// Design: as K3, one block per output time tile with a recomputed halo (the
// branches' 60 samples, plus conv_post's reach on the last stage).  The
// upsampled stage input cannot be read again from device memory, because it
// never exists there, so it gets a third shared-memory buffer; the staged
// input rows borrow the second conv's buffer, which is idle until the first
// conv has run; the finished branches' outputs wait in a scratch buffer in
// device memory for the last branch, as in K3.  conv_post has one output
// channel, so it runs as scalar f32 sums over the rounded activations, one
// output sample a thread.

#include "mrf_branch.cuh"

using namespace ovt;

namespace {

struct TailArgs {
    int t_in, cin, chan, stride, k_up, pad_up, in_margin, k_post, rows, tile;
};

__global__ void __launch_bounds__(512, 1)
tail_stage_kernel(const bf16* __restrict__ x, const int* __restrict__ lengths,
                  const uint2* __restrict__ up_frag, const bf16* __restrict__ up_bias,
                  const uint2* __restrict__ wfrag, const bf16* __restrict__ bias,
                  const bf16* __restrict__ post_w, bf16* __restrict__ out, bf16* __restrict__ scratch,
                  TailArgs a, MrfMeta meta) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int chan = a.chan, cin = a.cin, rows = a.rows, tile = a.tile, u = a.stride;
    const int ld = chan + LD_PAD, ldin = cin + LD_PAD;
    const int in_rows = rows / u + 2 * a.in_margin;
    const int ldz = max(ld, ldin);
    const bool is_last = post_w != nullptr;
    const int post_half = is_last ? (a.k_post - 1) / 2 : 0;

    bf16* zero_row = reinterpret_cast<bf16*>(smem);
    bf16* x0 = zero_row + ldz;
    bf16* xb = x0 + static_cast<size_t>(rows) * ld;
    bf16* xt = xb + static_cast<size_t>(rows) * ld;
    bf16* xin = xt;  // the staged input borrows xt until the upsample is done

    const int b = blockIdx.y;
    bf16* parked = scratch + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * (meta.n_branches - 1) *
                                 (tile + 2 * post_half) * chan;
    const int halo = (rows - tile) / 2;
    const int t_out = a.t_in * u;
    const int t0 = blockIdx.x * tile;
    const int pos0 = t0 - halo;          // a multiple of u: tile and halo are
    const int m0 = pos0 / u;             // exact, also when negative
    const int len_out = min(lengths[b], t_out);
    const int len_in = len_out / u;
    const int tid = threadIdx.x, n_threads = blockDim.x;
    const float slope_f = __bfloat162float(__float2bfloat16_rn(0.1f));

    for (int i = tid; i < ldz; i += n_threads) zero_row[i] = __float2bfloat16_rn(0.f);
    // staged input row i is input sample m0 - in_margin + i, activated and masked
    {
        const bf16* xrow = x + static_cast<size_t>(b) * a.t_in * cin;
        const int pairs = cin / 2;
        for (int i = tid; i < in_rows * pairs; i += n_threads) {
            const int row = i / pairs, c = (i % pairs) * 2;
            const int m = m0 - a.in_margin + row;
            float2 v = make_float2(0.f, 0.f);
            if (m >= 0 && m < len_in) {
                v = __bfloat1622float2(*reinterpret_cast<const bf162*>(xrow + static_cast<size_t>(m) * cin + c));
                v.x = lrelu_bf16(v.x, slope_f);
                v.y = lrelu_bf16(v.y, slope_f);
            }
            *reinterpret_cast<bf162*>(xin + static_cast<size_t>(row) * ldin + c) = __floats2bfloat162_rn(v.x, v.y);
        }
    }
    __syncthreads();

    auto live = [&](int row) { const int p = pos0 + row; return p >= 0 && p < len_out; };
    // upsample, one output phase at a time
    for (int f = 0; f < u; ++f) {
        const int j0 = (f + a.pad_up) % u;
        const int ds0 = (f + a.pad_up) / u;
        const int n_taps = (a.k_up - j0 + u - 1) / u;
        conv_rows<false>(xin, ldin, in_rows, a.in_margin, (rows / u) / TILE_ROWS, cin, zero_row, up_frag,
                         chan, n_taps, ds0, -1, j0, u, up_bias, no_slope(),
                         [&](int row, int col, float v0, float v1) {
                             const int orow = row * u + f;
                             const bool ok = live(orow);
                             *reinterpret_cast<bf162*>(x0 + static_cast<size_t>(orow) * ld + col) =
                                 __floats2bfloat162_rn(ok ? v0 : 0.f, ok ? v1 : 0.f);
                         });
    }
    __syncthreads();

    MrfWindow w;
    w.xb = xb; w.xt = xt; w.parked = parked; w.zero_row = zero_row;
    w.rows = rows; w.ld = ld; w.chan = chan;
    w.acc_row0 = halo - post_half; w.acc_rows = tile + 2 * post_half;
    w.pos0 = pos0; w.length = len_out;

    const int vec = chan / 8;
    bf16* orow = out + static_cast<size_t>(b) * t_out * chan;  // middle stage: [B, T_out, C]
    const float slope_post = __bfloat162float(__float2bfloat16_rn(0.01f));
    mrf_branches(
        w, meta, wfrag, bias,
        [&]() {
            for (int i = tid; i < rows * vec; i += n_threads) {
                const size_t off = static_cast<size_t>(i / vec) * ld + (i % vec) * 8;
                *reinterpret_cast<uint4*>(xb + off) = *reinterpret_cast<const uint4*>(x0 + off);
            }
        },
        [&](int row, int col, float m0_, float m1_) {
            if (is_last) {
                // the last branch has copied x0 away: it now holds the
                // activated mean that conv_post reads
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

// Shared memory of one block, in bytes.
extern "C" int tail_stage_smem_bytes(int cin, int chan, int stride, int in_margin, int rows) {
    const int ld = chan + LD_PAD, ldin = cin + LD_PAD;
    const int in_rows = rows / stride + 2 * in_margin;
    const long long xt = (long long)rows * ld > (long long)in_rows * ldin ? (long long)rows * ld
                                                                            : (long long)in_rows * ldin;
    return static_cast<int>(((ld > ldin ? ld : ldin) + 2LL * rows * ld + xt) * 2);
}

// x [batch, t_in, cin] bf16; lengths [batch] int32 true OUTPUT sample counts;
// up_frag [k_up][cin/16][chan/8][32] fragment words (tap j is the transposed
// convolution's W[:, :, j]); up_bias [chan]; wfrag, bias, ksizes, dilations as
// mrf_stage_bf16; post_w [k_post][chan] bf16 or null; scratch: batch *
// ceil(t_out / tile) * (n_branches - 1) * (tile + k_post - 1) * chan bf16
// (tile rows a block without post_w).  out is [batch, t_in * stride, chan]
// bf16 for a middle stage and [batch, t_in * stride] bf16 audio when post_w is
// given.  cin % 16 == chan % 16 == 0; rows % (32 * stride) == 0;
// tile and the halo (rows - tile) / 2 are multiples of stride.  Returns the
// CUDA error of the launch (0 on success), -1 for too many branches or pairs.
extern "C" int tail_stage_bf16(const void* x, const int* lengths, const void* up_frag,
                               const void* up_bias, const void* wfrag, const void* bias,
                               const void* post_w, void* out, void* scratch, int batch, int t_in, int cin, int chan,
                               int stride, int k_up, int pad_up, int in_margin, int k_post,
                               int n_branches, int n_pairs, const int* ksizes, const int* dilations,
                               int rows, int tile, int threads, int device, void* stream) {
    if (n_branches < 1 || n_branches > MAX_BRANCHES || n_pairs < 1 || n_pairs > MAX_PAIRS) return -1;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int smem = tail_stage_smem_bytes(cin, chan, stride, in_margin, rows);
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
        static_cast<bf16*>(scratch), a,
        make_meta(n_branches, n_pairs, ksizes, dilations));
    return static_cast<int>(cudaGetLastError());
}
