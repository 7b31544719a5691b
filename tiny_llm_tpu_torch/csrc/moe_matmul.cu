// Grouped W4A16 group-128 and W4A8 expert matmuls for Hopper (sm_90a):
// the MoE layers' gate, up and down projections.
//
// Replaces tiny_llm_tpu/kernels/moe_matmul.py::_gqmm_magic_kernel (through
// _gqmm_magic_pallas / grouped_quantized_matmul). x [T, Kp] holds rows
// sorted by expert; expert e owns the segment [goffs[e], goffs[e + 1]) with
// goffs the exclusive prefix sum of group_sizes [E]. Computes
//   out[t, n] = bf16( sum_k x[t, k] * (q[e(t), n, k] * s[e(t), n, g] + b[e(t), n, g]) )
// with f32 accumulation and the per-group scale/bias fold in f32, as K1.
// Weights: stacked experts in the port's row-major layout, packed int32
// [E, N, Kp/8], scales/biases bf16 [E, N, G].
//
// group_sizes stays on the device (moe_walk.cuh): each block finds its
// segment itself, so the host launches a grid fixed by T, N and E and
// never reads the sizes or syncs.
//
// Bound on the H100: the bytes of the active experts' weights (0.53 B per
// weight) plus x and out, over 3.35 TB/s — at a decode step (T = 8 rows,
// 8 experts) ~6.7 MB and ~2 us per gate or up call. The bf16 tensor-core
// rate binds only when many rows share an expert (T >= ~300 per expert).
//
// Design, two schedules chosen by T (the host knows T; the TPU switches
// its block height on T too):
//  * T <= 64, `moe_gemv`: grid (N / 8, min(E, T)), block row j on the j-th
//    expert that has rows, K1's warp-per-output-row body (qmm_tile.cuh
//    gemv_rows, through moe_walk.cuh gemv_expert) over that expert's
//    weights and rows, up to 8 rows per pass over the weights. (A grid over all E experts, the empty ones exiting
//    at once, leaves 120 of 128 block rows idle at T = 8.)
//  * T > 64, `moe_tiled`: a walk over logical tiles (expert, 64-row block
//    of the expert's segment), each a 64x64 tensor-core tile (qmm_tile.cuh
//    tile) from the expert's first row, so a tile never holds two experts'
//    rows. The TPU walks global m-tiles instead, and an m-tile shared by
//    two experts carries its accumulator between two sequential grid
//    steps; here no carry and no atomics are needed, and there are at most
//    as many tiles as the TPU's tiles_m + E - 1 (sum ceil(c_e / 64) <=
//    ceil(T / 64) + E - 1). Invalid logical tiles exit.
//
// The W4A8 walk, `tlt_grouped_quant_matmul_a8`, replaces _gqmm_pair_kernel
// (through _gqmm_pair_pallas) at its int8 shapes, T <= 128 grouped rows:
// per grouped row sx = max|x| / 127 over the row's K, xq = clip(rint(x /
// sx), ±127), and out = bf16( sx * sum_g (s_g (xq_g . q_g) + b_g sum xq_g) )
// with s32 integer dots and the fold in f32 (K1's W4A8 arithmetic, per
// expert). Design, `moe_a8_gemv`: the GEMV walk above at every T <= 128
// (a decode step of 16 rows x top-8, or a 16-token prompt tail, spreads
// its 128 rows over up to 128 experts, a few rows each), on the W4A8 body
// (qmm_tile.cuh gemv_a8_rows): each block quantizes its expert's rows, 8
// at a time, into shared memory, then runs __dp4a dots. Bound: the active
// experts' weight bytes, as above.
#include "moe_walk.cuh"

namespace {

// Grid (N / 8, min(E, T)): block row j serves the j-th expert that has rows.
__global__ void __launch_bounds__(256) moe_gemv(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const int* __restrict__ gs, __nv_bfloat16* __restrict__ out, int T, int N, int Kp, int E) {
  moe::gemv_expert(x, w, s, b, gs, out, T, N, Kp, E);
}

// Grid (N / 64, tiles_m + E - 1): block row i is logical tile i, the
// (expert, 64-row block) pairs in expert order.
__global__ void __launch_bounds__(128) moe_tiled(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const int* __restrict__ gs, __nv_bfloat16* __restrict__ out, int T, int N, int Kp, int E) {
  moe::tile_expert(x, w, s, b, gs, out, T, N, Kp, E);
}

// Grid (N / 8, min(E, T)), as moe_gemv, on the W4A8 body; dynamic shared
// memory qmm::a8_smem_bytes(8, Kp).
__global__ void __launch_bounds__(256) moe_a8_gemv(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const int* __restrict__ gs, __nv_bfloat16* __restrict__ out, int T, int N, int Kp, int E) {
  extern __shared__ __align__(16) unsigned char smem[];
  moe::gemv_expert(x, w, s, b, gs, out, T, N, Kp, E, moe::A8Rows{smem});
}

}  // namespace

extern "C" int tlt_grouped_quant_matmul(const void* x, const void* w, const void* s,
                                        const void* b, const void* group_sizes, void* out,
                                        int T, int N, int Kp, int E, void* stream) {
  if (Kp % qmm::GS != 0 || T <= 0 || N <= 0 || E <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint32_t*>(w);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  const auto* bp = static_cast<const __nv_bfloat16*>(b);
  const auto* gp = static_cast<const int*>(group_sizes);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (T <= moe::GEMV_MAX_T) {
    moe_gemv<<<dim3((N + 7) / 8, min(E, T)), dim3(256), 0, st>>>(xp, wp, sp, bp, gp, op, T, N,
                                                                 Kp, E);
  } else {
    const int tiles_m = (T + qmm::BM - 1) / qmm::BM;
    moe_tiled<<<dim3((N + qmm::BN - 1) / qmm::BN, tiles_m + E - 1), dim3(128), 0, st>>>(
        xp, wp, sp, bp, gp, op, T, N, Kp, E);
  }
  return (int)cudaGetLastError();
}

extern "C" int tlt_grouped_quant_matmul_a8(const void* x, const void* w, const void* s,
                                           const void* b, const void* group_sizes, void* out,
                                           int T, int N, int Kp, int E, void* stream) {
  if (Kp % qmm::GS != 0 || T <= 0 || T > 128 || N <= 0 || E <= 0)
    return (int)cudaErrorInvalidValue;
  static size_t allowed = 48 * 1024;  // raised once per size, not per launch
  const size_t smem = qmm::a8_smem_bytes(8, Kp);
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        moe_a8_gemv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  moe_a8_gemv<<<dim3((N + 7) / 8, min(E, T)), dim3(256), smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(w),
      static_cast<const __nv_bfloat16*>(s), static_cast<const __nv_bfloat16*>(b),
      static_cast<const int*>(group_sizes), static_cast<__nv_bfloat16*>(out), T, N, Kp, E);
  return (int)cudaGetLastError();
}
