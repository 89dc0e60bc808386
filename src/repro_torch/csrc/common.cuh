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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

// Register-blocked fp32 tile product: acc += As^T-slab x Bs-slab over BK.
//
// As is [BK][LDA] (the M operand, k-major), Bs is [BK][LDB] (the N
// operand, k-major), both f32 in shared memory with LDA, LDB multiples of
// 4. Thread (tm, tn) owns the IM float4 groups of rows
// {i * (BM / IM) + tm * 4 + 0..3} and the JN float4 groups of columns
// {j * (BN / JN) + tn * 4 + 0..3}: the threads of one warp then read a
// k-row of Bs as one contiguous run of float4s (no bank conflicts) and a
// k-row of As as a broadcast. Each output element is summed in k order by
// one thread, so the result does not change from run to run.
template <int BM, int BN, int BK, int IM, int JN, int LDA, int LDB>
__device__ __forceinline__ void tile_fma(const float* __restrict__ As,
                                         const float* __restrict__ Bs,
                                         float (&acc)[4 * IM][4 * JN],
                                         int tm, int tn) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float a[4 * IM], b[4 * JN];
#pragma unroll
    for (int i = 0; i < IM; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(
          As + kk * LDA + i * (BM / IM) + tm * 4);
      a[4 * i] = v.x; a[4 * i + 1] = v.y; a[4 * i + 2] = v.z; a[4 * i + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(
          Bs + kk * LDB + j * (BN / JN) + tn * 4);
      b[4 * j] = v.x; b[4 * j + 1] = v.y; b[4 * j + 2] = v.z; b[4 * j + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < 4 * IM; ++i)
#pragma unroll
      for (int j = 0; j < 4 * JN; ++j)
        acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Row (or column) of accumulator slot `s` for a thread at position `t`.
template <int B, int I>
__device__ __forceinline__ int tile_pos(int s, int t) {
  return (s / 4) * (B / I) + t * 4 + (s % 4);
}
