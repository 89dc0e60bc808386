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
