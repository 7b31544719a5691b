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

// Asynchronous copies (cp.async) into shared memory, by shared address.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// 4 bytes global -> shared (any 4-byte alignment); src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Where the K (and V: both share one layout) row at position `pos` of one
// (batch row, KV head) lives, as an element offset from the base pointer.
// The attention kernels take one of these, so a dense slab and a page pool
// run the same code.
template <int D>
struct SlabRows {  // a dense slab: the head's rows [0, S) from `base`
  size_t base;
  __device__ __forceinline__ size_t operator()(int pos) const {
    return base + (size_t)pos * D;
  }
};

template <int D>
struct PageRows {  // a page pool [P, hp, ps, D] through one block-table row
  const int* bt;   // the batch row's block table (-1 padded)
  int ps, hp, h;   // hp: the KV heads a page holds (a head shard reads in place)
  __device__ __forceinline__ size_t operator()(int pos) const {
    const int page = max(__ldg(bt + pos / ps), 0);  // -1 -> trash page 0
    return (((size_t)page * hp + h) * ps + pos % ps) * D;
  }
};
