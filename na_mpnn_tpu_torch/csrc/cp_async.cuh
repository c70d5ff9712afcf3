// Asynchronous copies from global to shared memory (cp.async, sm_80+),
// for the kernels that stream their operands through a ring:
// message_table.cu, message_table_bwd.cu and rbf_classed.cu. A copy lands when its group has been
// waited for; a barrier then makes it visible to the other threads.
#pragma once
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

// 16 bytes from src to dst (both 16-byte aligned); zero-filled when !valid
// (src must still be an address inside the operand).
__device__ __forceinline__ void async_copy16(void* dst, const void* src,
                                             bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace
