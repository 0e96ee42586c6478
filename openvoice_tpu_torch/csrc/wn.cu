// K1: a whole L-layer WaveNet stack in one launch.
//
// Replaces the TPU kernel openvoice_tpu/ops/wn_pallas.py::fused_wn_stack
// (body _wn_kernel): per layer a K-tap conv H -> 2H off the residual, plus
// bias and that layer's conditioning slice, a tanh*sigmoid gate, a 1x1
// res|skip product, a masked residual update and an f32 skip sum; the output
// is the skip sum, rounded once and masked.  The rounding points are the
// Pallas body's (see wn_layer.cuh).
//
// What bounds it: 2*T*L*(K+1)*H*2H operations (14.5 GFLOP at T=1024, L=16,
// K=5, H=192) against 14 MB of weights and under 1 MB of activations, so
// operations bound it, and the layers form one dependent chain.
//
// Design: the TPU keeps all T frames of one batch row in fast memory; an SM
// cannot ([1024, 192] bf16 is 384 KiB against 227 KiB).  So time is cut into
// tiles, one block each, and each block carries a halo of L*(K-1)/2 frames a
// side that it recomputes: its window goes stale by (K-1)/2 rows a layer from
// both edges and the rows in the middle stay exact.  Blocks never talk, so the
// kernel needs no co-residency and takes any T and any B.  The price is
// recomputation (window rows / tile rows) and few blocks at B = 1.  The
// alternative, the residual in device memory and a grid-wide barrier between
// layers, uses every SM but needs a cooperative launch sized to the card.
// Products run on the tensor cores through mma_tile.cuh.

#include "wn_layer.cuh"

using namespace ovt;

namespace {

__global__ void __launch_bounds__(512, 1)
wn_stack_kernel(const bf16* __restrict__ x, const int* __restrict__ lengths,
                const uint2* __restrict__ w_in, const bf16* __restrict__ b_in,
                const bf16* __restrict__ g_all, const uint2* __restrict__ w_rs,
                const bf16* __restrict__ b_rs, bf16* __restrict__ out, int t_len, int hidden,
                int ksize, int n_layers, int rows, int tile) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int ld = hidden + LD_PAD;
    bf16* zero_row = reinterpret_cast<bf16*>(smem);
    bf16* xs = zero_row + ld;
    bf16* acts = xs + static_cast<size_t>(rows) * ld;
    float* skip = reinterpret_cast<float*>(acts + static_cast<size_t>(rows) * ld);

    const int b = blockIdx.y;
    const int halo = (rows - tile) / 2;
    const int t0 = blockIdx.x * tile;
    const int frame0 = t0 - halo;
    const int length = min(lengths[b], t_len);
    const int tid = threadIdx.x, n_threads = blockDim.x;

    for (int i = tid; i < ld; i += n_threads) zero_row[i] = __float2bfloat16_rn(0.f);
    // the window, masked: frames outside [0, length) are zero
    const int vec = hidden / 8;
    const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < rows * vec; i += n_threads) {
        const int row = i / vec, c8 = (i % vec) * 8;
        const int frame = frame0 + row;
        uint4 v = zero4;
        if (frame >= 0 && frame < length)
            v = *reinterpret_cast<const uint4*>(x + (static_cast<size_t>(b) * t_len + frame) * hidden + c8);
        *reinterpret_cast<uint4*>(xs + static_cast<size_t>(row) * ld + c8) = v;
    }
    __syncthreads();

    WnWindow w;
    w.xs = xs; w.acts = acts; w.skip = skip; w.zero_row = zero_row;
    w.rows = rows; w.ld = ld; w.hidden = hidden; w.ksize = ksize;
    w.skip_row0 = halo; w.skip_rows = tile;
    w.frame0 = frame0; w.length = length;

    const size_t in_words = static_cast<size_t>(ksize) * (hidden / 16) * (2 * hidden / 8) * 32;
    const size_t rs_words = static_cast<size_t>(hidden / 16) * (2 * hidden / 8) * 32;
    for (int l = 0; l < n_layers; ++l) {
        wn_layer(w, w_in + l * in_words, b_in + l * 2 * hidden,
                 g_all + (static_cast<size_t>(b) * n_layers + l) * 2 * hidden,
                 w_rs + l * rs_words, b_rs + l * 2 * hidden, l == 0, l == n_layers - 1);
    }

    // skip sum, rounded once, masked; frames past the length come out 0
    for (int i = tid; i < tile * (hidden / 2); i += n_threads) {
        const int r = i / (hidden / 2), c = (i % (hidden / 2)) * 2;
        const int frame = t0 + r;
        if (frame >= t_len) continue;
        const bool live = frame < length;
        const float v0 = live ? skip[static_cast<size_t>(r) * hidden + c] : 0.f;
        const float v1 = live ? skip[static_cast<size_t>(r) * hidden + c + 1] : 0.f;
        *reinterpret_cast<bf162*>(out + (static_cast<size_t>(b) * t_len + frame) * hidden + c) =
            __floats2bfloat162_rn(v0, v1);
    }
}

}  // namespace

// Shared memory of one block, in bytes.
extern "C" int wn_stack_smem_bytes(int hidden, int rows, int tile) {
    const int ld = hidden + LD_PAD;
    return (1 + 2 * rows) * ld * 2 + tile * hidden * 4;
}

// x, out [batch, t_len, hidden] bf16; lengths [batch] int32; w_in
// [L][K][H/16][2H/8][32] 8-byte fragment words; b_in, b_rs [L][2H] bf16; g_all
// [batch][L][2H] bf16; w_rs [L][H/16][2H/8][32].  hidden % 16 == 0; rows % 32
// == 0; rows - tile is twice the halo, at least L*(K-1).  Returns the CUDA
// error of the launch (0 on success).
extern "C" int wn_stack_bf16(const void* x, const int* lengths, const void* w_in, const void* b_in,
                             const void* g_all, const void* w_rs, const void* b_rs, void* out,
                             int batch, int t_len, int hidden, int ksize, int n_layers, int rows,
                             int tile, int threads, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int smem = wn_stack_smem_bytes(hidden, rows, tile);
    err = cudaFuncSetAttribute(wn_stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((t_len + tile - 1) / tile, batch);
    wn_stack_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), lengths, static_cast<const uint2*>(w_in),
        static_cast<const bf16*>(b_in), static_cast<const bf16*>(g_all),
        static_cast<const uint2*>(w_rs), static_cast<const bf16*>(b_rs), static_cast<bf16*>(out),
        t_len, hidden, ksize, n_layers, rows, tile);
    return static_cast<int>(cudaGetLastError());
}
