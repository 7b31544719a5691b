// The any-width dequant-fused matmul for Hopper (sm_90a): weights of 2, 4
// or 8 bits in groups of 32, 64 or 128, other than K1's W4 g128.
//
// Replaces tiny_llm_tpu/kernels/quant_matmul.py::_qmm_kernel (through
// _qmm_pallas / quantized_matmul, the "sg" layout). Computes K1's
//   out[m, n] = bf16( sum_k x[m, k] * (q[n, k] * s[n, g] + b[n, g]) (+ res[m, n]) )
// with f32 accumulation and the per-group fold in f32 (the TPU kernel
// rounds q * s, then + b, to bf16 before its dot; its XLA twin rounds the
// dequantized weight to bf16 once). x is bf16 [M, Kp], Kp a multiple of
// 128 (the wrapper zero-pads K).
//
// Bound on the H100: at decode the packed weight bytes (bits / 8 B per
// weight plus 4 B per group) over 3.35 TB/s, so W8 reads twice W4's bytes
// and W2 half; the bf16 tensor-core rate at prefill for wide folds.
//
// Design: K1's two schedules (qmm_tile.cuh) with the width as template
// parameters, one instantiation per supported (bits, group) pair:
//  * M <= 32, `qmm_sg_gemv`: one warp per output row, 16-byte loads of 16,
//    32 or 64 codes (inside one group, or two whole groups at W2 g32),
//    instances for 1, 4 and 8 x rows per pass over the weights.
//  * M > 32, `qmm_sg_tiled`: one 64x64 tensor-core tile per 4-warp block,
//    128 k per stage; codes up to 255 are exact bf16 integers, so the tile
//    feeds the tensor cores exactly, and the scale/bias fold runs once per
//    group in registers.
#include "qmm_tile.cuh"

namespace {

template <int MT, int BITS, int GSZ>
__global__ void __launch_bounds__(256) qmm_sg_gemv(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out,
    int M, int N, int Kp) {
  qmm::gemv_rows<MT, BITS, GSZ>(x, w, s, b, res, out, blockIdx.y * MT, M, N, Kp);
}

template <int BITS, int GSZ>
__global__ void __launch_bounds__(128) qmm_sg_tiled(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out,
    int M, int N, int Kp) {
  qmm::tile<BITS, GSZ>(x, w, s, b, res, out, blockIdx.y * qmm::BM, blockIdx.x * qmm::BN, M, N,
                       Kp);
}

template <int BITS, int GSZ>
void launch(const __nv_bfloat16* x, const uint32_t* w, const __nv_bfloat16* s,
            const __nv_bfloat16* b, const __nv_bfloat16* res, __nv_bfloat16* out, int M, int N,
            int Kp, cudaStream_t st) {
  const dim3 rows((N + 7) / 8);  // 256 threads, one warp per output row
  if (M == 1) {
    qmm_sg_gemv<1, BITS, GSZ><<<rows, dim3(256), 0, st>>>(x, w, s, b, res, out, M, N, Kp);
  } else if (M <= 4) {
    qmm_sg_gemv<4, BITS, GSZ><<<rows, dim3(256), 0, st>>>(x, w, s, b, res, out, M, N, Kp);
  } else if (M <= 32) {
    qmm_sg_gemv<8, BITS, GSZ><<<dim3(rows.x, (M + 7) / 8), dim3(256), 0, st>>>(
        x, w, s, b, res, out, M, N, Kp);
  } else {
    qmm_sg_tiled<BITS, GSZ><<<dim3((N + qmm::BN - 1) / qmm::BN, (M + qmm::BM - 1) / qmm::BM),
                              dim3(128), 0, st>>>(x, w, s, b, res, out, M, N, Kp);
  }
}

}  // namespace

extern "C" int tlt_quant_matmul_sg(const void* x, const void* w, const void* s,
                                   const void* b, const void* res, void* out, int M, int N,
                                   int Kp, int bits, int group_size, void* stream) {
  if (Kp % qmm::KU != 0 || M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint32_t*>(w);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  const auto* bp = static_cast<const __nv_bfloat16*>(b);
  const auto* rp = static_cast<const __nv_bfloat16*>(res);
  auto* op = static_cast<__nv_bfloat16*>(out);
#define TLT_SG_CASE(B, G)                                   \
  case B * 1000 + G:                                        \
    launch<B, G>(xp, wp, sp, bp, rp, op, M, N, Kp, st);     \
    break;
  switch (bits * 1000 + group_size) {
    TLT_SG_CASE(2, 32) TLT_SG_CASE(2, 64) TLT_SG_CASE(2, 128)
    TLT_SG_CASE(4, 32) TLT_SG_CASE(4, 64)
    TLT_SG_CASE(8, 32) TLT_SG_CASE(8, 64) TLT_SG_CASE(8, 128)
    default:
      return (int)cudaErrorInvalidValue;  // W4 g128 is K1's; other widths are not taken
  }
#undef TLT_SG_CASE
  return (int)cudaGetLastError();
}
