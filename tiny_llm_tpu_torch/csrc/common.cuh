// Helpers shared by the port's CUDA kernels (built with nvcc for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TLT_NEG_INF (-1e30f)  // flash_attention_pallas.py NEG_INF

extern "C" const char* tlt_errstr(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) { return __bfloat162float(v); }

// Round a float to bf16 and back (the JAX package's rounding points).
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The low / high bf16 of a 32-bit word holding two consecutive elements.
__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
