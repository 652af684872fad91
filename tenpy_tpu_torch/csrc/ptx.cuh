// PTX wrappers for the packed-contraction kernel: asynchronous global ->
// shared copies (cp.async, sm_80+) and the f64 tensor-core product
// (mma.sync m8n8k4, sm_80+).  Hopper's wgmma takes no f64 operands; its f64
// tensor cores are reached through mma.sync.
#pragma once

#include <stdint.h>

namespace ptx {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy BYTES (4, 8 or 16) from global to shared memory without passing
// through registers.  With valid == false nothing is read and the BYTES of
// shared memory are zero-filled: that is how ragged edges are masked.
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* smem, const void* gmem,
                                               bool valid) {
    static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async size");
    const int src_bytes = valid ? BYTES : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_addr(smem)), "l"(gmem), "n"(BYTES),
                    "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// d = a * b + d on the f64 tensor cores, one warp, shape m8n8k4.
// Fragments (lane = %laneid): a = A[lane / 4][lane % 4] (A is 8 x 4),
// b = B[lane % 4][lane / 4] (B is 4 x 8),
// d0, d1 = D[lane / 4][2 * (lane % 4) + 0, 1] (D is 8 x 8).
__device__ __forceinline__ void mma_m8n8k4_f64(double& d0, double& d1,
                                               double a, double b) {
    asm volatile(
        "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1}, {%2}, {%3}, {%4, %5};\n"
        : "=d"(d0), "=d"(d1)
        : "d"(a), "d"(b), "d"(d0), "d"(d1));
}

}  // namespace ptx
