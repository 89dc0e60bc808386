// Asynchronous global-to-shared copies for the port's pipelined mainloops
// (pca_project_kernel, topk_chunk_kernel).
//
// A stage of a shared-memory ring is filled by 16-byte `cp.async.cg` copies
// (L2 only, no register staging) and waited for with `cp.async.wait_group`;
// the block barrier that follows the wait makes every thread's copies
// visible. A copy whose predicate is false writes 16 zero bytes and reads
// nothing, so ragged rows need no second path.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
