// Shared helpers of the renderer's CUDA kernels.
//
// Built with -fmad=false and without --use_fast_math: every mul+add below is
// two roundings, as in the plain PyTorch versions, so a kernel repeats its
// plain version's arithmetic operation for operation.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// NaN-propagating min/max and clamp, the semantics of torch.minimum /
// torch.maximum / torch.clamp (fminf/fmaxf would drop a NaN operand).
__device__ __forceinline__ float minp(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}
__device__ __forceinline__ float maxp(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}
__device__ __forceinline__ float clampp(float x, float lo, float hi) {
  return minp(maxp(x, lo), hi);
}
