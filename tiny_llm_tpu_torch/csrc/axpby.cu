// axpby, the port's tutorial kernel: out = alpha * x + beta * y, for Hopper
// (sm_90a). Replaces tiny_llm_tpu/kernels/axpby.py::_axpby_kernel (the
// "hello, Pallas" op, wrapper `axpby`).
//
// How a kernel of this package is made, in the order the pieces appear
// (kernels/axpby.py is the Python half):
//
//   1. The KERNEL: a __global__ function that one thread block of 256
//      threads runs; blockIdx and threadIdx pick this thread's elements.
//      There is no BlockSpec pipeline as in Pallas: the thread computes its
//      own offsets and masks the ragged tail itself. Each thread moves 16
//      bytes (8 bf16 or 4 f32 values) per load, neighbouring threads on
//      neighbouring addresses, so a warp reads 512 contiguous bytes.
//   2. The LAUNCHER: a template that picks the grid (how many blocks) and
//      launches on the caller's CUDA stream, returning cudaGetLastError()
//      so a refused launch is not silently lost.
//   3. The C ENTRY POINT: an extern "C" function with plain pointer and int
//      arguments. kernels/build.py compiles this file with `nvcc -shared`
//      for sm_90a into build/, and the Python wrapper loads it with ctypes,
//      passes tensor.data_ptr() and the current stream, checks the error
//      code, and counts the launch.
//
// Rounding points are the JAX expression's, `alpha * x + beta * y` in x's
// dtype: alpha and beta round to that dtype, each product rounds to it,
// then the sum does (bf16: f32 arithmetic, rounded after each op; f32: one
// IEEE op each, no fused multiply-add).
//
// Bound on the H100: two reads and one write of M * N elements over 3.35
// TB/s (three 128 MB arrays at 8192 x 8192 in bf16: 0.11 ms); no
// arithmetic to speak of. The 16-byte accesses are what this design does
// about it.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float axpby1(float a, float x, float b, float y, __nv_bfloat16) {
  return __fadd_rn(round_bf16(__fmul_rn(a, x)), round_bf16(__fmul_rn(b, y)));
}
__device__ __forceinline__ float axpby1(float a, float x, float b, float y, float) {
  return __fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y));
}
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void from_f(float v, float* o) { *o = v; }

template <typename T>
__global__ void __launch_bounds__(THREADS) axpby_kernel(const T* __restrict__ x,
                                                        const T* __restrict__ y,
                                                        T* __restrict__ out, long long n,
                                                        float alpha, float beta) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte access
  const long long i0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (i0 >= n) return;
  if (i0 + VEC <= n) {
    uint4 xv = __ldg(reinterpret_cast<const uint4*>(x + i0));
    uint4 yv = __ldg(reinterpret_cast<const uint4*>(y + i0));
    const T* xs = reinterpret_cast<const T*>(&xv);
    const T* ys = reinterpret_cast<const T*>(&yv);
    uint4 ov;
    T* os = reinterpret_cast<T*>(&ov);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      from_f(axpby1(alpha, to_f(xs[e]), beta, to_f(ys[e]), T()), os + e);
    *reinterpret_cast<uint4*>(out + i0) = ov;
  } else {
    for (long long i = i0; i < n; ++i)
      from_f(axpby1(alpha, to_f(x[i]), beta, to_f(y[i]), T()), out + i);
  }
}

template <typename T>
int launch(const void* x, const void* y, void* out, long long n, float alpha, float beta,
           cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const long long blocks = (n + (long long)THREADS * VEC - 1) / ((long long)THREADS * VEC);
  axpby_kernel<T><<<dim3((unsigned)blocks), dim3(THREADS), 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out), n, alpha, beta);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 bf16, 1 f32. alpha and beta arrive already rounded to the dtype.
// x, y and out are contiguous and 16-byte aligned (as torch allocates).
extern "C" int tlt_axpby(const void* x, const void* y, void* out, long long n, int dtype,
                         float alpha, float beta, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<__nv_bfloat16>(x, y, out, n, alpha, beta, st);
  if (dtype == 1) return launch<float>(x, y, out, n, alpha, beta, st);
  return (int)cudaErrorInvalidValue;
}
