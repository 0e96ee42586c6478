// K3: one HiFi-GAN multi-receptive-field stage in one launch.
//
// Replaces the TPU kernel openvoice_tpu/ops/mrf_pallas.py::fused_mrf_stage
// (body _mrf_kernel): the mean of the stage's ResBlock1 branches (kernel
// sizes 3/7/11, dilations 1/3/5: 18 convs of [C, C] taps, leaky ReLU 0.1, a
// mask rebuilt from the true sample length before every conv, bias, residual
// adds), with the activation read once and written once.  Rounding points:
// mrf_branch.cuh.
//
// What bounds it: 2*T*126*C*C operations (135 GFLOP at T=8192, C=256; 271
// GFLOP at T=65536, C=128) against 2*T*C*2 bytes of activation and 126*C*C*2
// bytes of weights, more than 3000 operations a byte, so operations bound it.
//
// Design: one block per time tile.  Its window (tile + a 60-sample halo a
// side at the V2 branches) lives in shared memory as two bf16 buffers, the
// running residual and the second conv's operand.  The halo is recomputed by
// both neighbours: the window goes stale inwards by each conv's reach and the
// tile stays exact.  Shared memory is what limits the window, and the halo is
// fixed, so everything else is kept out of it: the stage input is read again
// from device memory (L2) at the start of each branch instead of being kept
// in a third buffer, and the finished branches' outputs wait in a scratch
// buffer in device memory until the last branch sums them (each thread reads
// back only what it wrote itself, so no barrier guards it).  Even so C = 256
// has a 192-row window for a 72-sample tile, 2.7x recomputation, against
// 1.45x at C = 128.  Weights are read by every block from L2 in fragment
// order.  Products run on the tensor cores through mma_tile.cuh.

#include "mrf_branch.cuh"

using namespace ovt;

namespace {

__global__ void __launch_bounds__(512, 1)
mrf_stage_kernel(const bf16* __restrict__ x, const int* __restrict__ lengths,
                 const uint2* __restrict__ wfrag, const bf16* __restrict__ bias,
                 bf16* __restrict__ out, bf16* __restrict__ scratch, int t_len, int chan, int rows,
                 int tile, MrfMeta meta) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int ld = chan + LD_PAD;
    bf16* zero_row = reinterpret_cast<bf16*>(smem);
    bf16* xb = zero_row + ld;
    bf16* xt = xb + static_cast<size_t>(rows) * ld;

    const int b = blockIdx.y;
    bf16* parked = scratch + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * (meta.n_branches - 1) *
                                 tile * chan;
    const int halo = (rows - tile) / 2;
    const int t0 = blockIdx.x * tile;
    const int pos0 = t0 - halo;
    const int length = min(lengths[b], t_len);
    const int tid = threadIdx.x, n_threads = blockDim.x;
    for (int i = tid; i < ld; i += n_threads) zero_row[i] = __float2bfloat16_rn(0.f);

    MrfWindow w;
    w.xb = xb; w.xt = xt; w.parked = parked; w.zero_row = zero_row;
    w.rows = rows; w.ld = ld; w.chan = chan;
    w.acc_row0 = halo; w.acc_rows = tile;
    w.pos0 = pos0; w.length = length;

    const bf16* xrow = x + static_cast<size_t>(b) * t_len * chan;
    bf16* orow = out + static_cast<size_t>(b) * t_len * chan;
    const int vec = chan / 8;
    mrf_branches(
        w, meta, wfrag, bias,
        [&]() {
            const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
            for (int i = tid; i < rows * vec; i += n_threads) {
                const int row = i / vec, c8 = (i % vec) * 8;
                const int pos = pos0 + row;
                uint4 v = zero4;
                if (pos >= 0 && pos < length)
                    v = *reinterpret_cast<const uint4*>(xrow + static_cast<size_t>(pos) * chan + c8);
                *reinterpret_cast<uint4*>(xb + static_cast<size_t>(row) * ld + c8) = v;
            }
        },
        [&](int row, int col, float m0, float m1) {
            const int pos = pos0 + row;
            if (pos < t_len)
                *reinterpret_cast<bf162*>(orow + static_cast<size_t>(pos) * chan + col) =
                    __floats2bfloat162_rn(m0, m1);
        });
}

}  // namespace

// Shared memory of one block, in bytes.
extern "C" int mrf_stage_smem_bytes(int chan, int rows) {
    const int ld = chan + LD_PAD;
    return (1 + 2 * rows) * ld * 2;
}

// x, out [batch, t_len, chan] bf16; lengths [batch] int32 true sample counts;
// wfrag: all taps in execution order, [n_taps][C/16][C/8][32] fragment words;
// bias [n_convs][C] bf16; ksizes [n_branches]; dilations [n_branches][n_pairs];
// scratch: batch * ceil(t_len / tile) * (n_branches - 1) * tile * chan bf16.
// chan % 16 == 0; rows % 32 == 0; rows - tile is twice the halo.  Returns the
// CUDA error of the launch (0 on success), -1 for too many branches or pairs.
extern "C" int mrf_stage_bf16(const void* x, const int* lengths, const void* wfrag, const void* bias,
                              void* out, void* scratch, int batch, int t_len, int chan,
                              int n_branches, int n_pairs, const int* ksizes, const int* dilations,
                              int rows, int tile, int threads, int device, void* stream) {
    if (n_branches < 1 || n_branches > MAX_BRANCHES || n_pairs < 1 || n_pairs > MAX_PAIRS) return -1;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int smem = mrf_stage_smem_bytes(chan, rows);
    err = cudaFuncSetAttribute(mrf_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((t_len + tile - 1) / tile, batch);
    mrf_stage_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), lengths, static_cast<const uint2*>(wfrag),
        static_cast<const bf16*>(bias), static_cast<bf16*>(out), static_cast<bf16*>(scratch), t_len,
        chan, rows, tile, make_meta(n_branches, n_pairs, ksizes, dilations));
    return static_cast<int>(cudaGetLastError());
}
