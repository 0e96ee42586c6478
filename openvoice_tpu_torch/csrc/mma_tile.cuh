// What every tensor-core kernel of the port shares: the bf16 types, the row
// padding of shared-memory windows, ldmatrix, and the bf16 rounding helpers
// that put the kernels' rounding points where the bf16 graph has them.  The
// products themselves are Hopper's warpgroup MMA (wgmma.cuh): K3's and K4's
// with A from registers by ldmatrix_x4, K1's and K2's with A from shared
// memory, B from the weight ring (ring.cuh) in both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ovt {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int LD_PAD = 8;        // row padding (elements): rows land 16 B apart mod 128 B

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
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

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ bf162 no_slope() { return __float2bfloat162_rn(0.f); }

}  // namespace ovt
