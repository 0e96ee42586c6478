// mbarriers and 1-D bulk async copies (sm_90), shared by the kernels that
// stream their weights into shared memory: the MRF-stage kernel (mrf.cu, K3)
// and the decoder-tail kernel (tail.cu, K4).
//
// A bulk copy moves a contiguous run of bytes from device memory into shared
// memory and reports its bytes to an mbarrier as a transaction: the barrier's
// phase completes once its expected arrivals have arrived and every byte
// announced with mbar_expect_tx has landed.  On an H100 the bulk copies one
// thread issues complete one after another, about 450-470 cycles apart at any
// size up to 16 KB, so a kernel moves several slabs a copy and lets different
// threads issue its copies.  Shared-memory addresses are 32-bit shared::cta
// addresses (smem_u32).

#pragma once

#include <stdint.h>

namespace ovt {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// Spin until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

// One 1-D bulk copy global -> shared (at `dst`) whose bytes complete a transaction on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
}

}  // namespace ovt
