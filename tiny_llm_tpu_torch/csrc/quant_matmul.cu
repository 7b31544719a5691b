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
// with s32 integer dots and the fold in f32. Bound: the same weight bytes
// as K1 at decode (the int8 dots need 1/1979 TOPS, far below). Two routes,
// chosen by M on the host:
//  * M <= 2 (decode), `qmm_a8_gemv` (qmm_tile.cuh gemv_a8_rows): each block
//    quantizes its MT rows of x into shared memory first (one launch per
//    matmul, as K1), then K1's warp-per-row GEMV with two __dp4a per weight
//    word. Every 8-column block quantizes the rows again, and 8 rows share
//    one pass over the weights.
//  * 2 < M <= 32, the int8 tensor-core tile (qmm_tile.cuh a8::): the
//    quantize kernel `qmm_a8_quantize` writes xq, the group code sums and sx
//    once to a workspace the wrapper allocates (its size from
//    tlt_quant_matmul_a8_workspace), then `qmm_a8_tile` reads
//    each weight once for all M rows through a cp.async ring and runs
//    mma.sync s8 (IMMA), 128 columns a block; where those blocks do not
//    fill the SMs (down, qkv, o), a cluster of up to 8 blocks splits a
//    column block's k-range and adds the partial tiles through distributed
//    shared memory. A launch failure of either kernel is returned.
#include <algorithm>

#include "qmm_tile.cuh"

namespace {

// Rows above take the int8 tile. Measured with both routes forced (PERF.md):
// at M = 1 the GEMV is 1.4-2.4x faster on every shape; at M = 2 it wins a
// Qwen3-4B layer's four projections together, at M = 3 the tile does (by a
// fifth; Qwen3-30B-A3B's qkv and o alone still favour the GEMV there), at
// M = 4 the tile wins on every shape.
constexpr int A8_GEMV_MAX_ROWS = 2;

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

// Row blockIdx.x of x into the workspace (qmm_tile.cuh a8::quantize_row).
__global__ void __launch_bounds__(1024) qmm_a8_quantize(const __nv_bfloat16* __restrict__ x,
                                                       void* ws, int M, int Kp) {
  __shared__ float red[32];
  qmm::a8::let_dependents_launch();
  qmm::a8::quantize_row(x, blockIdx.x, M, Kp, qmm::a8::carve(ws, M, Kp), red);
}

// Grid (column blocks x ranks, 1), clusters of `ranks` blocks along x: the
// blocks of a cluster share one column block, each a k-range of it.
__global__ void __launch_bounds__(qmm::a8::THREADS, 2) qmm_a8_tile(
    void* ws, const uint32_t* __restrict__ w, const __nv_bfloat16* __restrict__ s,
    const __nv_bfloat16* __restrict__ b, const __nv_bfloat16* __restrict__ res,
    __nv_bfloat16* __restrict__ out, int M, int N, int Kp, int ranks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const qmm::a8::Quantized q = qmm::a8::carve(ws, M, Kp);
  const int rank = blockIdx.x % ranks, n0 = blockIdx.x / ranks * qmm::a8::BN;
  const int G = Kp / qmm::GS;
  qmm::a8::Acc acc = {};
  qmm::a8::tile_mma(q, M, w, s, b, 0, M, n0, N, Kp, rank * G / ranks, (rank + 1) * G / ranks,
                    smem, acc);
  qmm::a8::tile_store(acc, res, out, 0, M, n0, N, rank, ranks, smem);
}

// The int8 tensor-core route: the quantize kernel, then the tile over
// ceil(N / BN) column blocks.
cudaError_t a8_tile_route(const __nv_bfloat16* x, const uint32_t* w, const __nv_bfloat16* s,
                          const __nv_bfloat16* b, const __nv_bfloat16* res, __nv_bfloat16* out,
                          int M, int N, int Kp, void* ws, size_t ws_bytes, cudaStream_t st) {
  if (ws == nullptr || ws_bytes < qmm::a8::workspace_bytes(M, Kp)) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm_a8_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, qmm::a8::SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  qmm_a8_quantize<<<M, qmm::a8::quantize_threads(Kp), 0, st>>>(x, ws, M, Kp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int cols = (N + qmm::a8::BN - 1) / qmm::a8::BN;
  // Split each column block's k-range over a cluster of up to 8 blocks
  // (each one group at least) while the grid stays within one block an SM:
  // a second block on an SM would stream its bytes after the first's.
  const int ranks = std::max(1, std::min({8, Kp / qmm::GS, qmm::a8::sm_count() / cols}));
  return qmm::a8::launch_tile(qmm_a8_tile, dim3(cols * ranks, 1), ranks, st, ws, w, s, b, res,
                              out, M, N, Kp, ranks);
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

// The tile route's workspace for M rows of Kp, in bytes: 0 on the GEMV
// route (M <= A8_GEMV_MAX_ROWS), where the entry takes none. The wrapper
// asks here, so the crossover lives in this file alone.
extern "C" size_t tlt_quant_matmul_a8_workspace(int M, int Kp) {
  return M > A8_GEMV_MAX_ROWS ? qmm::a8::workspace_bytes(M, Kp) : 0;
}

// ws: the workspace of the tile route (tlt_quant_matmul_a8_workspace(M,
// Kp) bytes, 16-byte aligned), or null on the GEMV route.
extern "C" int tlt_quant_matmul_a8(const void* x, const void* w, const void* s,
                                   const void* b, const void* res, void* out, int M, int N,
                                   int Kp, void* ws, size_t ws_bytes, void* stream) {
  if (Kp % qmm::GS != 0 || M <= 0 || M > 32 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint32_t*>(w);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  const auto* bp = static_cast<const __nv_bfloat16*>(b);
  const auto* rp = static_cast<const __nv_bfloat16*>(res);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (M > A8_GEMV_MAX_ROWS)
    return (int)a8_tile_route(xp, wp, sp, bp, rp, op, M, N, Kp, ws, ws_bytes, st);
  if (M == 1) return (int)launch_a8<1>(xp, wp, sp, bp, rp, op, M, N, Kp, st);
  return (int)launch_a8<4>(xp, wp, sp, bp, rp, op, M, N, Kp, st);
}
