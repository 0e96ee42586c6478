// K3: one HiFi-GAN multi-receptive-field stage in one launch.
//
// Replaces the TPU kernel openvoice_tpu/ops/mrf_pallas.py::fused_mrf_stage
// (body _mrf_kernel): the mean of the stage's ResBlock1 branches (kernel
// sizes 3/7/11, dilations 1/3/5: 18 convs of [C, C] taps, leaky ReLU 0.1, a
// mask rebuilt from the true sample length before every conv, bias, residual
// adds), with the activation read once and written once.
//
// What bounds it: 2*T*126*C*C operations (135 GFLOP at T=8192, C=256; 271
// GFLOP at T=65536, C=128) against 2*T*C*2 bytes of activation and 126*C*C*2
// bytes of weights, more than 3000 operations a byte, so operations bound it.
//
// Shared with K4 (mrf_core.cuh): the weight ring, the product loop and the
// branch loop, with the rounding points, the conv ranges and their 64-row
// tiles.  K3's own: its window layout, the staging of the stage input and
// the store of its result.  One block per time tile.  Its window (tile + a
// 60-sample halo a side at the V2 branches) lives in shared memory as two
// bf16 buffers, the running residual and the second conv's operand, each
// row's 16-byte chunks XOR-swizzled by the row (`SwizzledRows`), so that
// ldmatrix's eight rows fall on different banks without padding.  The stage
// input is read again from device memory (L2) at the start of each branch
// instead of being kept in a third buffer.  The products' N is C, or C split
// in N-wide parts where C is wider than 256 or 256 does not divide it.
//
// What holds it on an H100 (PERF.md): at C = 256 the window (192
// rows, 72 kept) computes 2.19x the useful products with its 64-row tiles
// (1.87x at the former 16-row grain, 2.67x with tiles at 64-row boundaries);
// at C = 128 (384 rows, 264 kept) 1.32x.  Shared memory leaves the ring 4
// slabs at C = 256 (two groups), 8 at C = 128.  One block takes as long as
// the whole grid, and of its time the tensor cores are busy a little over a
// third: each warpgroup's own loads, waits and releases between its groups,
// the ring (a group's refill waits for the slowest warpgroup's release of
// it), and the epilogues and block barriers between convs, during which no
// product runs.  PERF.md keeps the ablations that weigh these.

#include "mrf_core.cuh"

using namespace ovt;

namespace {

constexpr int WARPGROUPS = 3;  // ops/mrf_cuda.py::WARPGROUPS

// Slabs of a ring group, which a warpgroup's products take between waits
// (ops/mrf_cuda.py::ring_group): two at N = 256, whose 128 accumulators a
// thread leave room for two slabs' fragments, four below.
__host__ __device__ constexpr int group_of(int n) { return n >= 256 ? 2 : 4; }

// Element (row, col) of a window row lies at row * C + col(row, col): the
// 16-byte chunk col / 8 at chunk (col / 8) ^ (row % 8).  frag(row, kt, h):
// where the 8 columns kt * 16 + h * 8 start.
struct SwizzledRows {
    static __device__ __forceinline__ int col(int row, int c) {
        return (((c >> 3) ^ (row & 7)) << 3) | (c & 7);
    }
    static __device__ __forceinline__ int frag(int row, int kt, int h) { return (((kt << 1) | h) ^ (row & 7)) << 3; }
};

template <int N>
__global__ void __launch_bounds__(WARPGROUPS * 128, 1)
mrf_stage_kernel(const bf16* __restrict__ x, const int* __restrict__ lengths,
                 const unsigned char* __restrict__ wslabs, const bf16* __restrict__ bias,
                 bf16* __restrict__ out, bf16* __restrict__ scratch, int t_len, int chan, int rows,
                 int tile, MrfMeta meta, RingPlan plan) {
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + (SLAB_ALIGN - smem_u32(smem_raw) % SLAB_ALIGN) % SLAB_ALIGN;
    Ring ring;
    bf16* zero_row = reinterpret_cast<bf16*>(ring_start<WARPGROUPS, group_of(N)>(ring, plan, smem, wslabs, 32 * chan));
    bf16* xb = zero_row + chan;
    bf16* xt = xb + static_cast<size_t>(rows) * chan;

    const int b = blockIdx.y;
    const int halo = (rows - tile) / 2;
    const int pos0 = blockIdx.x * tile - halo;
    const int length = min(lengths[b], t_len);
    const int tid = threadIdx.x, n_threads = blockDim.x;
    for (int i = tid; i < chan; i += n_threads) zero_row[i] = __float2bfloat16_rn(0.f);

    MrfWindow w;
    w.xb = xb; w.xt = xt; w.zero_row = zero_row;
    w.parked = scratch + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * (meta.n_branches - 1) * tile * chan;
    w.rows = rows; w.ld = chan; w.chan = chan;
    w.acc_row0 = halo; w.acc_rows = tile;
    w.pos0 = pos0; w.length = length;

    const bf16* xrow = x + static_cast<size_t>(b) * t_len * chan;
    bf16* orow = out + static_cast<size_t>(b) * t_len * chan;
    const int vec = chan / 8;
    mrf_branches<N, WARPGROUPS, group_of(N), SwizzledRows>(
        w, meta, plan, 0, ring, bias,
        [&]() {
            const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
            for (int i = tid; i < rows * vec; i += n_threads) {
                const int row = i / vec, c8 = (i % vec) * 8;
                const int pos = pos0 + row;
                uint4 v = zero4;
                if (pos >= 0 && pos < length)
                    v = *reinterpret_cast<const uint4*>(xrow + static_cast<size_t>(pos) * chan + c8);
                *reinterpret_cast<uint4*>(xb + static_cast<size_t>(row) * chan + SwizzledRows::col(row, c8)) = v;
            }
        },
        [&](int row, int col, float m0, float m1) {
            const int pos = pos0 + row;
            if (pos < t_len)
                *reinterpret_cast<bf162*>(orow + static_cast<size_t>(pos) * chan + col) =
                    __floats2bfloat162_rn(m0, m1);
        });
}

// The kernel instance of a product width, or null.
typedef void (*KernelFn)(const bf16*, const int*, const unsigned char*, const bf16*, bf16*, bf16*, int, int, int,
                         int, MrfMeta, RingPlan);

KernelFn kernel_for(int width) {
    switch (width) {
        case 64: return mrf_stage_kernel<64>;
        case 128: return mrf_stage_kernel<128>;
        case 256: return mrf_stage_kernel<256>;
        default: return nullptr;
    }
}

// The product width of C channels (ops/mrf_cuda.py::product_width): the
// widest instance that divides it.
int width_of(int chan) { return chan % 256 == 0 ? 256 : chan % 128 == 0 ? 128 : 64; }

}  // namespace

// Shared memory of one block, in bytes: room to align the ring, its
// `ring_slabs` slabs of 32 * chan bytes in `stages` groups and their
// barriers, then the window (a row of zeros and the two buffers), 16-byte
// aligned throughout as the bulk copies and ldmatrix ask.
extern "C" int mrf_stage_smem_bytes(int chan, int rows, int ring_slabs, int stages) {
    const long long bytes = SLAB_ALIGN + ring_bytes(32 * chan, ring_slabs, stages) + (1LL + 2LL * rows) * chan * 2;
    return bytes > 0x7fffffff ? 0x7fffffff : static_cast<int>(bytes);
}

// Registers a thread and local (spilled) bytes of the kernel instance of a
// product width: out[0], out[1].  Returns the CUDA error (0 on success), -1
// for an instance that does not exist.
extern "C" int mrf_stage_attributes(int width, int* out) {
    const KernelFn fn = kernel_for(width);
    if (fn == nullptr) return -1;
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
    return 0;
}

// x, out [batch, t_len, chan] bf16; lengths [batch] int32 true sample counts;
// wslabs: all taps in execution order, [n_taps][C/16] slabs of wgmma.cuh's
// B layout (32 * C bytes each); bias [n_convs][C] bf16; ksizes [n_branches];
// dilations [n_branches][n_pairs]; plan [n_convs][PLAN_FIELDS]: each conv's
// first window row, its nonzero count of 64-row tiles inside [0, rows), its
// slabs a round, its first slab and the ring groups of convs 0 .. cv
// (ops/_frag.py::ring_plan; `make_plan` checks it); stages (1 to
// MAX_STAGES) groups of `group` slabs in the ring, group_of(the product
// width); scratch: batch *
// ceil(t_len / tile) * (n_branches - 1) * tile * chan bf16.  chan % 64 == 0;
// rows - tile is twice the halo.  Returns the CUDA error of the launch (0 on
// success), -1 for too many branches or pairs, or a plan or ring the kernel
// cannot take.
extern "C" int mrf_stage_bf16(const void* x, const int* lengths, const void* wslabs, const void* bias,
                              void* out, void* scratch, int batch, int t_len, int chan,
                              int n_branches, int n_pairs, const int* ksizes, const int* dilations,
                              const int* plan_table, int rows, int tile, int stages, int group,
                              int device, void* stream) {
    if (n_branches < 1 || n_branches > MAX_BRANCHES || n_pairs < 1 || n_pairs > MAX_PAIRS || chan % 64 ||
        stages < 1)
        return -1;
    const int width = width_of(chan);
    RingPlan plan;
    if (group != group_of(width) ||
        !make_plan(plan, plan_table, 2 * n_branches * n_pairs, rows, chan / width, WARPGROUPS, stages, group))
        return -1;
    const KernelFn fn = kernel_for(width);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int smem = mrf_stage_smem_bytes(chan, rows, plan.ring_slabs, stages);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((t_len + tile - 1) / tile, batch);
    fn<<<grid, WARPGROUPS * 128, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), lengths, static_cast<const unsigned char*>(wslabs),
        static_cast<const bf16*>(bias), static_cast<bf16*>(out), static_cast<bf16*>(scratch), t_len, chan, rows,
        tile, make_meta(n_branches, n_pairs, ksizes, dilations), plan);
    return static_cast<int>(cudaGetLastError());
}
