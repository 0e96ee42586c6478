// Warp-level bf16 tensor-core tile product of the WaveNet kernels (wn.cu,
// coupling.cu).  The decoder kernels (mrf.cu, tail.cu), whose products run
// on wgmma (wgmma.cuh), take from here only the types, ldmatrix_x4 and the
// bf16 rounding helpers.
//
// Every product in the WaveNet kernels has the same form: a [rows, C_in] bf16
// activation that lives in shared memory, read at a row shift (a convolution
// tap), times a [C_in, N] bf16 weight matrix that lives in device memory,
// summed in f32.  One warp computes a 32-row x 32-column tile of the result
// with mma.sync.m16n8k16 (2 row tiles x 4 column tiles, 32 f32 accumulators a
// thread):
//
// * A fragments come from shared memory with ldmatrix.x4.  Rows outside the
//   buffer read a row of zeros, which is the convolution's zero padding.
// * B fragments come straight from device memory.  The host packs each
//   weight matrix in fragment order (ops/_frag.py::pack_frag): for k-tile kt
//   and column tile nt, lane l finds its two registers as one 8-byte word at
//   ((kt * n_tiles + nt) * 32 + l), so a warp's load is one coalesced 256-byte
//   line and needs no shared memory and no barrier.  The packed weights of a
//   stage stay in the 50 MB L2.
//
// Element (row, col) of an accumulator tile, for the epilogues:
//   acc[mt][j][c]: row = mt * 16 + lane / 4 + (c >= 2 ? 8 : 0)
//                  col = nt[j] * 8 + (lane % 4) * 2 + (c & 1)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ovt {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int MT = 2;            // 16-row tiles per warp tile
constexpr int NT = 4;            // 8-column tiles per warp tile
constexpr int TILE_ROWS = 16 * MT;
constexpr int LD_PAD = 8;        // row padding (elements): rows land 16 B apart mod 128 B

typedef float Acc[MT][NT][4];

__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[mt][j][c] = 0.f;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], const uint2 b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Round an f32 to the nearest bf16 and widen it again: the places where the
// kernels round are the places where the bf16 graph rounds.
__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// leaky ReLU in bf16 as the bf16 graph computes it: the slope is a bf16
// value and the product is rounded to bf16.
__device__ __forceinline__ float lrelu_bf16(float v, float slope_bf16) {
    return v >= 0.f ? v : round_bf16(v * slope_bf16);
}

__device__ __forceinline__ uint32_t lrelu_pair(uint32_t v, bf162 slope) {
    const bf162 x = *reinterpret_cast<const bf162*>(&v);
    const bf162 zero = __float2bfloat162_rn(0.f);
    // max(x, 0) + min(x, 0) * slope: one of the two terms is zero, so the one
    // rounding of the fused multiply-add is the rounding of the product
    const bf162 y = __hfma2(__hmin2(x, zero), slope, __hmax2(x, zero));
    return *reinterpret_cast<const uint32_t*>(&y);
}

// acc += A[row0 .. row0 + 32, 0 .. cin) @ W[0 .. cin, the four column tiles nt[]]
//
// a: shared-memory activation [a_rows][lda] bf16; rows outside [0, a_rows)
//    read `zero_row` (at least cin zeros, 16-byte aligned).
// wfrag: the matrix W in fragment order, n_tiles = N / 8 column tiles.
// nt[j] < 0 leaves column tile j out.
// LRELU applies the bf16 leaky ReLU to A on its way into the product.
template <bool LRELU>
__device__ __forceinline__ void warp_gemm(Acc& acc, const bf16* __restrict__ a, int lda, int a_rows,
                                          int row0, const bf16* __restrict__ zero_row, int cin,
                                          const uint2* __restrict__ wfrag, int n_tiles,
                                          const int (&nt)[NT], bf162 slope) {
    const int lane = threadIdx.x & 31;
    const int lrow = lane & 15;
    const int lcol = (lane >> 4) * 8;
    const bf16* arow[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        const int row = row0 + mt * 16 + lrow;
        arow[mt] = (row >= 0 && row < a_rows) ? a + static_cast<size_t>(row) * lda + lcol
                                              : zero_row + lcol;
    }
    const int k_tiles = cin >> 4;
    for (int kt = 0; kt < k_tiles; ++kt) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            ldmatrix_x4(af[mt], arow[mt] + kt * 16);
            if (LRELU) {
#pragma unroll
                for (int i = 0; i < 4; ++i) af[mt][i] = lrelu_pair(af[mt][i], slope);
            }
        }
        const uint2* wk = wfrag + (static_cast<size_t>(kt) * n_tiles) * 32 + lane;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            if (nt[j] < 0) continue;
            const uint2 b = __ldg(wk + nt[j] * 32);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma_16816(acc[mt][j], af[mt], b);
        }
    }
}

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ bf162 no_slope() { return __float2bfloat162_rn(0.f); }

}  // namespace ovt
