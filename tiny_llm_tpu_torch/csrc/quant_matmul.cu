// K1 (W4A16 group-128 dequant-fused matmul) and the W4A8 matmul for
// Hopper (sm_90a).
//
// K1 replaces tiny_llm_tpu/kernels/quant_matmul.py::_magic_kernel (through
// _qmm_magic_pallas / quantized_matmul). Computes
//   out[m, n] = bf16( sum_k x[m, k] * (q[n, k] * s[n, g] + b[n, g]) (+ res[m, n]) )
// with f32 accumulation; the residual is added in f32 before the bf16 round.
// x is bf16 [M, Kp] (the wrapper zero-pads K to Kp).
//
// Bound on the H100: at decode (M <= 32) the bytes of the packed weights
// (0.5 B per weight plus 4 B per 128-weight group) over 3.35 TB/s; at
// prefill (M = 128) still the bytes for the narrow projections, the bf16
// tensor-core rate only for a full-width fold.
//
// Design (the bodies are qmm_tile.cuh's, shared with the grouped expert
// matmul and the any-width kernels):
//  * M <= 32, `qmm_gemv`: one warp per output row, instances for 1, 4 and
//    8 x rows per pass over the weights (the unused rows are masked).
//  * M > 32, `qmm_tiled`: one 64x64 tensor-core tile per 4-warp block.
//
// The W4A8 matmul, `tlt_quant_matmul_a8`, replaces _pair_kernel (through
// _qmm_pair_pallas) at its decode shapes, M <= 32 rows:
//   sx[m] = max_k |x[m, k]| / 127 (1 where 0), xq = clip(rint(x / sx), ±127),
//   out[m, n] = bf16( sx[m] * sum_g (s[n, g] * (xq_g . q_g) + b[n, g] * sum xq_g)
//                     (+ res[m, n]) )
// with s32 integer dots per 32 codes and the fold in f32. Bound: the same
// weight bytes as K1 at decode (the int8 dots need 1/1979 TOPS, far below).
// Design, `qmm_a8_gemv` (qmm_tile.cuh gemv_a8_rows): each block quantizes
// its MT rows of x into shared memory first (the activation quantization
// is fused: one launch per matmul, as K1), then K1's warp-per-row GEMV
// with two __dp4a per weight word. Each block rereads its rows of x (at
// most 8 x Kp bf16) from L2 for that; MT x Kp bytes of shared memory.
#include "qmm_tile.cuh"

namespace {

template <int MT>
__global__ void __launch_bounds__(256) qmm_gemv(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out,
    int M, int N, int Kp) {
  qmm::gemv_rows<MT>(x, w, s, b, res, out, blockIdx.y * MT, M, N, Kp);
}

__global__ void __launch_bounds__(128) qmm_tiled(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out,
    int M, int N, int Kp) {
  qmm::tile(x, w, s, b, res, out, blockIdx.y * qmm::BM, blockIdx.x * qmm::BN, M, N, Kp);
}

template <int MT>
__global__ void __launch_bounds__(256) qmm_a8_gemv(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out,
    int M, int N, int Kp) {
  extern __shared__ __align__(16) unsigned char smem[];
  qmm::gemv_a8_rows<MT>(x, w, s, b, res, out, blockIdx.y * MT, M, N, Kp, smem);
}

// Launch qmm_a8_gemv<MT>, allowing it the dynamic shared memory it needs.
template <int MT>
cudaError_t launch_a8(const __nv_bfloat16* x, const uint32_t* w, const __nv_bfloat16* s,
                      const __nv_bfloat16* b, const __nv_bfloat16* res, __nv_bfloat16* out,
                      int M, int N, int Kp, cudaStream_t st) {
  static size_t allowed = 48 * 1024;  // raised once per size, not per launch
  const size_t smem = qmm::a8_smem_bytes(MT, Kp);
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmm_a8_gemv<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  qmm_a8_gemv<MT><<<dim3((N + 7) / 8, (M + MT - 1) / MT), dim3(256), smem, st>>>(
      x, w, s, b, res, out, M, N, Kp);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tlt_quant_matmul(const void* x, const void* w, const void* s, const void* b,
                                const void* res, void* out, int M, int N, int Kp,
                                void* stream) {
  if (Kp % qmm::GS != 0 || M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint32_t*>(w);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  const auto* bp = static_cast<const __nv_bfloat16*>(b);
  const auto* rp = static_cast<const __nv_bfloat16*>(res);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (M <= 32) {
    const int rows_per_block = 8;  // 256 threads, one warp per row
    const dim3 block(256);
    if (M == 1) {
      qmm_gemv<1><<<dim3((N + 7) / rows_per_block, 1), block, 0, st>>>(xp, wp, sp, bp, rp, op, M, N, Kp);
    } else if (M <= 4) {
      qmm_gemv<4><<<dim3((N + 7) / rows_per_block, 1), block, 0, st>>>(xp, wp, sp, bp, rp, op, M, N, Kp);
    } else {
      qmm_gemv<8><<<dim3((N + 7) / rows_per_block, (M + 7) / 8), block, 0, st>>>(xp, wp, sp, bp, rp, op, M, N, Kp);
    }
  } else {
    qmm_tiled<<<dim3((N + qmm::BN - 1) / qmm::BN, (M + qmm::BM - 1) / qmm::BM), dim3(128), 0,
                st>>>(xp, wp, sp, bp, rp, op, M, N, Kp);
  }
  return (int)cudaGetLastError();
}

extern "C" int tlt_quant_matmul_a8(const void* x, const void* w, const void* s,
                                   const void* b, const void* res, void* out, int M, int N,
                                   int Kp, void* stream) {
  if (Kp % qmm::GS != 0 || M <= 0 || M > 32 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint32_t*>(w);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  const auto* bp = static_cast<const __nv_bfloat16*>(b);
  const auto* rp = static_cast<const __nv_bfloat16*>(res);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (M == 1) return (int)launch_a8<1>(xp, wp, sp, bp, rp, op, M, N, Kp, st);
  if (M <= 4) return (int)launch_a8<4>(xp, wp, sp, bp, rp, op, M, N, Kp, st);
  return (int)launch_a8<8>(xp, wp, sp, bp, rp, op, M, N, Kp, st);
}
