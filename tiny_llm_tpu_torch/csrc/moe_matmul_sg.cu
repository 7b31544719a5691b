// The grouped any-width expert matmul for Hopper (sm_90a): MoE experts of
// 2, 4 or 8 bits in groups of 32, 64 or 128, other than W4 g128 (whose
// kernel is moe_matmul.cu's).
//
// Replaces tiny_llm_tpu/kernels/moe_matmul.py::_gqmm_kernel (through
// _gqmm_pallas / grouped_quantized_matmul, the "sg" stacked layout). x
// [T, Kp] holds rows sorted by expert, group_sizes [E] on the device.
// Computes out[t, n] = bf16( sum_k x[t, k] * (q[e(t), n, k] * s[e(t), n, g] +
// b[e(t), n, g]) ) with f32 accumulation and the per-group fold in f32
// (the TPU kernel rounds q * s, then + b, to bf16 before its dot).
//
// Bound on the H100: the active experts' weight bytes (bits / 8 B per
// weight plus 4 B per group) plus x and out, over 3.35 TB/s; the bf16
// tensor-core rate only when many rows share an expert.
//
// Design: moe_matmul.cu's walk (moe_walk.cuh) over the generic bodies of
// qmm_tile.cuh, one instantiation per supported (bits, group) pair:
// T <= 64, `moe_sg_gemv` (the per-expert warp-per-output-row GEMV); above,
// `moe_sg_tiled` (64-row tensor-core tiles of one expert each).
#include "moe_walk.cuh"

namespace {

template <int BITS, int GSZ>
__global__ void __launch_bounds__(256) moe_sg_gemv(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const int* __restrict__ gs, __nv_bfloat16* __restrict__ out, int T, int N, int Kp, int E) {
  moe::gemv_expert<GSZ, moe::Bf16Rows<BITS, GSZ>>(x, w, s, b, gs, out, T, N, Kp, E);
}

template <int BITS, int GSZ>
__global__ void __launch_bounds__(128) moe_sg_tiled(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const int* __restrict__ gs, __nv_bfloat16* __restrict__ out, int T, int N, int Kp, int E) {
  moe::tile_expert<BITS, GSZ>(x, w, s, b, gs, out, T, N, Kp, E);
}

template <int BITS, int GSZ>
void launch(const __nv_bfloat16* x, const uint32_t* w, const __nv_bfloat16* s,
            const __nv_bfloat16* b, const int* gs, __nv_bfloat16* out, int T, int N, int Kp,
            int E, cudaStream_t st) {
  if (T <= moe::GEMV_MAX_T) {
    moe_sg_gemv<BITS, GSZ><<<dim3((N + 7) / 8, min(E, T)), dim3(256), 0, st>>>(
        x, w, s, b, gs, out, T, N, Kp, E);
  } else {
    const int tiles_m = (T + qmm::BM - 1) / qmm::BM;
    moe_sg_tiled<BITS, GSZ><<<dim3((N + qmm::BN - 1) / qmm::BN, tiles_m + E - 1), dim3(128), 0,
                              st>>>(x, w, s, b, gs, out, T, N, Kp, E);
  }
}

}  // namespace

extern "C" int tlt_grouped_quant_matmul_sg(const void* x, const void* w, const void* s,
                                           const void* b, const void* group_sizes, void* out,
                                           int T, int N, int Kp, int E, int bits,
                                           int group_size, void* stream) {
  if (Kp % qmm::KU != 0 || T <= 0 || N <= 0 || E <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint32_t*>(w);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  const auto* bp = static_cast<const __nv_bfloat16*>(b);
  const auto* gp = static_cast<const int*>(group_sizes);
  auto* op = static_cast<__nv_bfloat16*>(out);
#define TLT_SG_CASE(B, G)                                       \
  case B * 1000 + G:                                            \
    launch<B, G>(xp, wp, sp, bp, gp, op, T, N, Kp, E, st);      \
    break;
  switch (bits * 1000 + group_size) {
    TLT_SG_CASE(2, 32) TLT_SG_CASE(2, 64) TLT_SG_CASE(2, 128)
    TLT_SG_CASE(4, 32) TLT_SG_CASE(4, 64)
    TLT_SG_CASE(8, 32) TLT_SG_CASE(8, 64) TLT_SG_CASE(8, 128)
    default:
      return (int)cudaErrorInvalidValue;  // W4 g128 is moe_matmul.cu's; others not taken
  }
#undef TLT_SG_CASE
  return (int)cudaGetLastError();
}
