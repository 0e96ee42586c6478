// K2: one direction of the converter's coupling flow in one launch.
//
// Replaces the TPU kernel openvoice_tpu/ops/coupling_pallas.py::
// fused_coupling_block (body _coupling_kernel).  Per coupling step s, in
// execution order (the host packs forward or reverse order, folds the channel
// Flip into the pre/post matrices and negates post for reverse):
//   h     = bf16(state @ Wp[s] + bp[s]) * mask
//   skip  = WaveNet(h), L layers as in K1 (wn_layer.cuh), f32
//   m     = bf16(skip) * mask
//   state = bf16(state + bf16(m @ Wq[s] + bq[s])) * mask
// The state starts as x * mask; frames past the length come out exactly 0.
//
// What bounds it: operations, as K1 (15 GFLOP a direction at T=1024, C=H=192,
// S=4, L=4, K=5, against 3.7 MB of weights), in one dependent chain of
// S*(L+2) products.
//
// Design: as K1, time tiles with a recomputed halo, here S*L*(K-1)/2 frames a
// side because every step's WaveNet widens the reach.  A block holds the
// [rows, C] state, the WaveNet's residual and gate buffers and an f32 skip
// sum of the whole window in shared memory, which is what limits the window
// to 96 rows at C = H = 192.

#include "wn_layer.cuh"

using namespace ovt;

namespace {

__global__ void __launch_bounds__(512, 1)
coupling_kernel(const bf16* __restrict__ x, const int* __restrict__ lengths,
                const uint2* __restrict__ wp, const bf16* __restrict__ bp,
                const uint2* __restrict__ w_in, const bf16* __restrict__ b_in,
                const bf16* __restrict__ g_all, const uint2* __restrict__ w_rs,
                const bf16* __restrict__ b_rs, const uint2* __restrict__ wq,
                const bf16* __restrict__ bq, bf16* __restrict__ out, int t_len, int chan, int hidden,
                int ksize, int n_layers, int n_steps, int rows, int tile) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int ldc = chan + LD_PAD, ldh = hidden + LD_PAD;
    const int ldz = max(ldc, ldh);
    bf16* zero_row = reinterpret_cast<bf16*>(smem);
    bf16* state = zero_row + ldz;
    bf16* hs = state + static_cast<size_t>(rows) * ldc;
    bf16* acts = hs + static_cast<size_t>(rows) * ldh;
    float* skip = reinterpret_cast<float*>(acts + static_cast<size_t>(rows) * ldh);

    const int b = blockIdx.y;
    const int halo = (rows - tile) / 2;
    const int t0 = blockIdx.x * tile;
    const int frame0 = t0 - halo;
    const int length = min(lengths[b], t_len);
    const int tid = threadIdx.x, n_threads = blockDim.x;

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
    __syncthreads();

    WnWindow w;
    w.xs = hs; w.acts = acts; w.skip = skip; w.zero_row = zero_row;
    w.rows = rows; w.ld = ldh; w.hidden = hidden; w.ksize = ksize;
    w.skip_row0 = 0; w.skip_rows = rows;
    w.frame0 = frame0; w.length = length;
    auto live = [&](int row) { const int f = frame0 + row; return f >= 0 && f < length; };

    const size_t pre_words = static_cast<size_t>(chan / 16) * (hidden / 8) * 32;
    const size_t post_words = static_cast<size_t>(hidden / 16) * (chan / 8) * 32;
    const size_t in_words = static_cast<size_t>(ksize) * (hidden / 16) * (2 * hidden / 8) * 32;
    const size_t rs_words = static_cast<size_t>(hidden / 16) * (2 * hidden / 8) * 32;

    for (int s = 0; s < n_steps; ++s) {
        // pre 1x1 (flip and half-select folded into the matrix)
        conv_rows<false>(state, ldc, rows, 0, rows / TILE_ROWS, chan, zero_row, wp + s * pre_words,
                         hidden, 1, 0, 0, 0, 0, bp + s * hidden, no_slope(),
              [&](int row, int col, float v0, float v1) {
                  const bool ok = live(row);
                  *reinterpret_cast<bf162*>(hs + static_cast<size_t>(row) * ldh + col) =
                      __floats2bfloat162_rn(ok ? v0 : 0.f, ok ? v1 : 0.f);
              });
        __syncthreads();
        for (int l = 0; l < n_layers; ++l) {
            const size_t sl = static_cast<size_t>(s) * n_layers + l;
            wn_layer(w, w_in + sl * in_words, b_in + sl * 2 * hidden,
                     g_all + ((static_cast<size_t>(b) * n_steps + s) * n_layers + l) * 2 * hidden,
                     w_rs + sl * rs_words, b_rs + sl * 2 * hidden, l == 0, l == n_layers - 1);
        }
        // the WaveNet's output, rounded once and masked, is the post product's operand
        for (int i = tid; i < rows * (hidden / 2); i += n_threads) {
            const int row = i / (hidden / 2), c = (i % (hidden / 2)) * 2;
            const bool ok = live(row);
            const float v0 = ok ? skip[static_cast<size_t>(row) * hidden + c] : 0.f;
            const float v1 = ok ? skip[static_cast<size_t>(row) * hidden + c + 1] : 0.f;
            *reinterpret_cast<bf162*>(acts + static_cast<size_t>(row) * ldh + c) = __floats2bfloat162_rn(v0, v1);
        }
        __syncthreads();
        // post 1x1, scattered into the target half (sign folded in), and the state update
        conv_rows<false>(acts, ldh, rows, 0, rows / TILE_ROWS, hidden, zero_row, wq + s * post_words,
                         chan, 1, 0, 0, 0, 0, bq + s * chan, no_slope(),
              [&](int row, int col, float v0, float v1) {
                  bf162* ps = reinterpret_cast<bf162*>(state + static_cast<size_t>(row) * ldc + col);
                  if (live(row)) {
                      const float2 cur = __bfloat1622float2(*ps);
                      *ps = __floats2bfloat162_rn(cur.x + round_bf16(v0), cur.y + round_bf16(v1));
                  } else {
                      *ps = __float2bfloat162_rn(0.f);
                  }
              });
        __syncthreads();
    }

    for (int i = tid; i < tile * vec; i += n_threads) {
        const int r = i / vec, c8 = (i % vec) * 8;
        const int frame = t0 + r;
        if (frame >= t_len) continue;
        *reinterpret_cast<uint4*>(out + (static_cast<size_t>(b) * t_len + frame) * chan + c8) =
            *reinterpret_cast<const uint4*>(state + static_cast<size_t>(halo + r) * ldc + c8);
    }
}

}  // namespace

// Shared memory of one block, in bytes.
extern "C" int coupling_smem_bytes(int chan, int hidden, int rows) {
    const int ldc = chan + LD_PAD, ldh = hidden + LD_PAD;
    return ((ldc > ldh ? ldc : ldh) + rows * ldc + 2 * rows * ldh) * 2 + rows * hidden * 4;
}

// x, out [batch, t_len, chan] bf16; lengths [batch] int32; per step s: wp
// [S][C/16][H/8][32] fragment words, bp [S][H], w_in [S][L][K][H/16][2H/8][32],
// b_in, b_rs [S][L][2H], w_rs [S][L][H/16][2H/8][32], wq [S][H/16][C/8][32],
// bq [S][C]; g_all [batch][S][L][2H].  chan % 16 == hidden % 16 == 0; rows %
// 32 == 0; rows - tile is twice the halo, at least S*L*(K-1).  Returns the
// CUDA error of the launch (0 on success).
extern "C" int coupling_block_bf16(const void* x, const int* lengths, const void* wp, const void* bp,
                                   const void* w_in, const void* b_in, const void* g_all,
                                   const void* w_rs, const void* b_rs, const void* wq, const void* bq,
                                   void* out, int batch, int t_len, int chan, int hidden, int ksize,
                                   int n_layers, int n_steps, int rows, int tile, int threads,
                                   int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int smem = coupling_smem_bytes(chan, hidden, rows);
    err = cudaFuncSetAttribute(coupling_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((t_len + tile - 1) / tile, batch);
    coupling_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), lengths, static_cast<const uint2*>(wp),
        static_cast<const bf16*>(bp), static_cast<const uint2*>(w_in), static_cast<const bf16*>(b_in),
        static_cast<const bf16*>(g_all), static_cast<const uint2*>(w_rs),
        static_cast<const bf16*>(b_rs), static_cast<const uint2*>(wq), static_cast<const bf16*>(bq),
        static_cast<bf16*>(out), t_len, chan, hidden, ksize, n_layers, n_steps, rows, tile);
    return static_cast<int>(cudaGetLastError());
}
