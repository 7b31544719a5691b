// The any-width dequant-fused matmul for Hopper (sm_90a): weights of 2, 4
// or 8 bits in groups of 32, 64 or 128, other than K1's W4 g128.
//
// Replaces tiny_llm_tpu/kernels/quant_matmul.py::_qmm_kernel (through
// _qmm_pallas / quantized_matmul, the "sg" layout). Computes K1's
//   out[m, n] = bf16( sum_k x[m, k] * (q[n, k] * s[n, g] + b[n, g]) (+ res[m, n]) )
// with f32 accumulation. x is bf16 [M, Kp], Kp a multiple of 128 (the
// wrapper zero-pads K).
//
// Bound on the H100: at decode and serving rows the packed weight bytes
// (bits / 8 B per weight plus 4 B per group) over 3.35 TB/s, so W8 reads
// twice W4's bytes and W2 half; at prefill (M = 1024) the bf16
// tensor-core rate.
//
// Design: K1's three routes (quant_matmul.cu), their bodies made generic
// over the width (qmm_tile.cuh gemv_rows, qmm_tc.cuh b16:: and staged::,
// whose header says what changes with it), chosen by M on the host against
// two constants set from measurement (kernels/qmm_crossover.py --kind sg):
//  * M < B16_MIN_ROWS (decode), `qmm_sg_gemv<1>`: one warp per output
//    column, one pass over the weights per row, the scale/bias fold in f32.
//  * B16_MIN_ROWS <= M < STAGED_MIN_ROWS (batched decode, serving),
//    `qmm_sg_b16_tile`: weights by TMA through a ring, each word read once
//    for the block's 16 or 32 rows, bf16 mma.sync (HMMA) on exact integer
//    codes, the fold acc += d' s + xs (b - c s) in f32, the k-range split
//    over a cluster where the column blocks leave SMs idle.
//  * M >= STAGED_MIN_ROWS (prefill), `qmm_sg_staged_tile`: the
//    dequantized weight bf16(q s + b) staged in shared memory while
//    warpgroup MMAs (HGMMA) run on the stage before, k-split clusters
//    where the output tiles do not fill the SMs.
// One launch a call on every route; a launch failure is returned.
//
// A group size outside the templated widths (any other that divides K)
// takes `tlt_quant_matmul_sg_rt` at every M: the run-time-width SIMT walk of
// qmm_rt.cuh, `qmm_sg_rt_walk`, grid (column blocks of RT_WARPS, row blocks
// of RT_ROWS). One launch a call.
#include "qmm_rt.cuh"
#include "qmm_tc.cuh"
#include "qmm_tile.cuh"

namespace {

// The routes by rows, set from `python -m tiny_llm_tpu_torch.kernels.
// qmm_crossover --kind sg` (PERF.md): a Qwen3-4B layer's four projections,
// at W8 g64 and at W4 g32, take less time on the GEMV at M = 3 and on the
// bf16 tile at M = 4; on the bf16 tile at M = 32 and on the staged tile at
// M = 48.
constexpr int B16_MIN_ROWS = 4;
constexpr int STAGED_MIN_ROWS = 33;

// MT x rows a block row (MT = 1, the only instance): rows blockIdx.y.
template <int MT, int BITS, int GSZ>
__global__ void __launch_bounds__(256) qmm_sg_gemv(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out,
    int M, int N, int Kp) {
  qmm::gemv_rows<MT, BITS, GSZ>(x, w, s, b, res, out, blockIdx.y * MT, M, N, Kp);
}

// Grid (column blocks x ranks, row blocks), clusters of `ranks` blocks
// along x: the blocks of a cluster share one column block, each a k-range.
template <int MT, int BITS, int GSZ>
__global__ void __launch_bounds__(qmm::b16::THREADS, 2) qmm_sg_b16_tile(
    const __nv_bfloat16* __restrict__ x, const __grid_constant__ CUtensorMap wmap,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out, int M, int N,
    int Kp, int ranks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      qmm::b16::aligned_to<qmm::b16::Width<BITS, GSZ>::ALIGN>(smem_raw);
  const int rank = blockIdx.x % ranks, n0 = blockIdx.x / ranks * qmm::b16::BN;
  const int m0 = blockIdx.y * 16 * MT, G = Kp / qmm::KU;
  float acc[MT][2][4] = {};
  qmm::b16::tile_mma<MT, BITS, GSZ>(x, &wmap, s, b, m0, M, n0, N, Kp, rank * G / ranks,
                                    (rank + 1) * G / ranks, smem, acc);
  qmm::b16::tile_store<MT>(acc, res, out, m0, M, n0, N, rank, ranks, smem);
}

template <int MT, int BITS, int GSZ>
cudaError_t b16_route(const __nv_bfloat16* x, const uint32_t* w, const __nv_bfloat16* s,
                      const __nv_bfloat16* b, const __nv_bfloat16* res, __nv_bfloat16* out,
                      int M, int N, int Kp, cudaStream_t st) {
  constexpr int SMEM = qmm::b16::Shape<MT, BITS, GSZ>::SMEM_BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm_sg_b16_tile<MT, BITS, GSZ>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap wmap;
  const cudaError_t e =
      qmm::tma::cached_weight_map(&wmap, w, N, Kp, qmm::tma::row_swizzle(BITS), BITS);
  if (e != cudaSuccess) return e;
  const int cols = (N + qmm::b16::BN - 1) / qmm::b16::BN, rows = (M + 16 * MT - 1) / (16 * MT);
  const int ranks = qmm::cluster_ranks(Kp, cols * rows, qmm::a8::sm_count());
  return qmm::launch_clustered(qmm_sg_b16_tile<MT, BITS, GSZ>, dim3(cols * ranks, rows),
                               qmm::b16::THREADS, SMEM, ranks, st, x, wmap, s, b, res, out, M,
                               N, Kp, ranks);
}

// Grid (column blocks x ranks, row blocks), clusters of `ranks` blocks
// along x, as qmm_sg_b16_tile's.
template <int BITS, int GSZ>
__global__ void __launch_bounds__(qmm::staged::THREADS, 1) qmm_sg_staged_tile(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out, int M, int N,
    int Kp, int ranks) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rank = blockIdx.x % ranks, G = Kp / qmm::KU;
  qmm::staged::tile<BITS, GSZ>(&xmap, &wmap, s, b, res, out, blockIdx.y * qmm::staged::BM,
                               blockIdx.x / ranks * qmm::staged::BN, M, N, Kp, rank * G / ranks,
                               (rank + 1) * G / ranks, rank, ranks, smem);
}

template <int BITS, int GSZ>
cudaError_t staged_route(const __nv_bfloat16* x, const uint32_t* w, const __nv_bfloat16* s,
                         const __nv_bfloat16* b, const __nv_bfloat16* res, __nv_bfloat16* out,
                         int M, int N, int Kp, cudaStream_t st) {
  constexpr int SMEM = qmm::staged::Width<BITS, GSZ>::SMEM_BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm_sg_staged_tile<BITS, GSZ>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap xmap, wmap;  // x changes every call: its map is encoded each time
  cudaError_t e = qmm::tma::encode_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, Kp, M,
                                      (uint64_t)Kp * 2, 64, qmm::staged::BM,
                                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = qmm::tma::cached_weight_map(&wmap, w, N, Kp, qmm::tma::row_swizzle(BITS), BITS);
  if (e != cudaSuccess) return e;
  const int cols = (N + qmm::staged::BN - 1) / qmm::staged::BN;
  const int rows = (M + qmm::staged::BM - 1) / qmm::staged::BM;
  const int ranks = qmm::cluster_ranks(Kp, cols * rows, qmm::a8::sm_count());
  return qmm::launch_clustered(qmm_sg_staged_tile<BITS, GSZ>, dim3(cols * ranks, rows),
                               qmm::staged::THREADS, SMEM, ranks, st, xmap, wmap, s, b, res, out,
                               M, N, Kp, ranks);
}

template <int BITS, int GSZ>
cudaError_t launch(const __nv_bfloat16* x, const uint32_t* w, const __nv_bfloat16* s,
                   const __nv_bfloat16* b, const __nv_bfloat16* res, __nv_bfloat16* out, int M,
                   int N, int Kp, cudaStream_t st) {
  if (M >= STAGED_MIN_ROWS) return staged_route<BITS, GSZ>(x, w, s, b, res, out, M, N, Kp, st);
  if (M >= B16_MIN_ROWS) {
    if (M <= 16) return b16_route<1, BITS, GSZ>(x, w, s, b, res, out, M, N, Kp, st);
    return b16_route<2, BITS, GSZ>(x, w, s, b, res, out, M, N, Kp, st);  // 32-row blocks
  }
  qmm_sg_gemv<1, BITS, GSZ><<<dim3((N + 7) / 8, M), dim3(256), 0, st>>>(x, w, s, b, res, out, M,
                                                                         N, Kp);
  return cudaGetLastError();
}

// Columns blockIdx.x * RT_WARPS + warp, rows [blockIdx.y * RT_ROWS, + RT_ROWS).
template <int BITS>
__global__ void __launch_bounds__(32 * qmm_rt::RT_WARPS) qmm_sg_rt_walk(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out, int M, int N,
    int Kp, int gsz) {
  const int n = blockIdx.x * qmm_rt::RT_WARPS + (threadIdx.x >> 5);
  if (n >= N) return;
  const int m0 = blockIdx.y * qmm_rt::RT_ROWS, rows = min(qmm_rt::RT_ROWS, M - m0);
  const int G = Kp / gsz;
  float acc[qmm_rt::RT_ROWS] = {};
  qmm_rt::walk_row<BITS>(x + (size_t)m0 * Kp, rows, w + (size_t)n * (Kp / (32 / BITS)),
                         s + (size_t)n * G, b + (size_t)n * G, Kp, gsz, acc);
  qmm_rt::store_rows(acc, rows, res == nullptr ? nullptr : res + (size_t)m0 * N,
                     out + (size_t)m0 * N, n, N);
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
#define TLT_SG_CASE(B, G) \
  case B * 1000 + G:      \
    return (int)launch<B, G>(xp, wp, sp, bp, rp, op, M, N, Kp, st);
  switch (bits * 1000 + group_size) {
    TLT_SG_CASE(2, 32) TLT_SG_CASE(2, 64) TLT_SG_CASE(2, 128)
    TLT_SG_CASE(4, 32) TLT_SG_CASE(4, 64)
    TLT_SG_CASE(8, 32) TLT_SG_CASE(8, 64) TLT_SG_CASE(8, 128)
    default:
      return (int)cudaErrorInvalidValue;  // W4 g128 is K1's; other widths are not taken
  }
#undef TLT_SG_CASE
}

// The route for M rows: 0 the GEMV, 1 the bf16 tile, 2 the staged tile.
extern "C" int tlt_quant_matmul_sg_route(int M) {
  return M >= STAGED_MIN_ROWS ? 2 : M >= B16_MIN_ROWS ? 1 : 0;
}

// The run-time-width walk: any bits in {2, 4, 8} and any group size that
// divides Kp (the templated widths run tlt_quant_matmul_sg).
extern "C" int tlt_quant_matmul_sg_rt(const void* x, const void* w, const void* s,
                                      const void* b, const void* res, void* out, int M, int N,
                                      int Kp, int bits, int group_size, void* stream) {
  if (M <= 0 || N <= 0 || group_size <= 0 || Kp % group_size != 0 || Kp % qmm::KU != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + qmm_rt::RT_WARPS - 1) / qmm_rt::RT_WARPS,
                  (M + qmm_rt::RT_ROWS - 1) / qmm_rt::RT_ROWS);
  const dim3 block(32 * qmm_rt::RT_WARPS);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint32_t*>(w);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  const auto* bp = static_cast<const __nv_bfloat16*>(b);
  const auto* rp = static_cast<const __nv_bfloat16*>(res);
  auto* op = static_cast<__nv_bfloat16*>(out);
#define TLT_RT_CASE(B)                                                                   \
  case B:                                                                                \
    qmm_sg_rt_walk<B><<<grid, block, 0, st>>>(xp, wp, sp, bp, rp, op, M, N, Kp, group_size); \
    break;
  switch (bits) {
    TLT_RT_CASE(2) TLT_RT_CASE(4) TLT_RT_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TLT_RT_CASE
  return (int)cudaGetLastError();
}
