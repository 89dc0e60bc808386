// Shared pieces of the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel here accumulates in plain fp32 FMA on the CUDA cores: the
// parity bar against the reference is fp32, which the tensor cores reach
// only through TF32 (about three decimal digits). Index storage (bf16, int8)
// is upcast to f32 in registers; no f32 copy of an index is ever written.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// One kernel of a source for the resource check (analysis/kernel_budget.py):
// its name, its address, the threads a launch gives it and the dynamic
// shared memory a launch asks for at index width m (null: none).
struct KernelEntry {
  const char* name;
  const void* fn;
  int threads;
  int (*dyn_smem)(int m);
};

// Entry i of `table` (count entries): *name, and attrs[0..6] = registers a
// thread, static shared bytes, the dynamic shared bytes the kernel may ask
// for, local (stack and spill) bytes a thread, the most threads a block may
// have, the threads a launch gives it, and the dynamic shared bytes a
// launch asks for at width m. Returns -1 past the table, else the
// cudaError_t of cudaFuncGetAttributes.
inline int kernel_attrs(const KernelEntry* table, int count, int i, int m, const char** name,
                        int* attrs) {
  if (i < 0 || i >= count) return -1;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, table[i].fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *name = table[i].name;
  attrs[0] = a.numRegs;
  attrs[1] = static_cast<int>(a.sharedSizeBytes);
  attrs[2] = a.maxDynamicSharedSizeBytes;
  attrs[3] = static_cast<int>(a.localSizeBytes);
  attrs[4] = a.maxThreadsPerBlock;
  attrs[5] = table[i].threads;
  attrs[6] = table[i].dyn_smem == nullptr ? 0 : table[i].dyn_smem(m);
  return 0;
}
