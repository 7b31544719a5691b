// K1 (W4A16 group-128 dequant-fused matmul) and the W4A8 matmul for
// Hopper (sm_90a).
//
// K1 replaces tiny_llm_tpu/kernels/quant_matmul.py::_magic_kernel (through
// _qmm_magic_pallas / quantized_matmul). Computes
//   out[m, n] = bf16( sum_k x[m, k] * (q[n, k] * s[n, g] + b[n, g]) (+ res[m, n]) )
// with f32 accumulation; the residual is added in f32 before the bf16 round.
// x is bf16 [M, Kp] (the wrapper zero-pads K to Kp).
//
// Bound on the H100: at decode and serving rows the bytes of the packed
// weights (0.5 B per weight plus 4 B per 128-weight group) over 3.35 TB/s;
// at prefill (M = 1024) the bf16 tensor-core rate for every projection.
//
// Design: three routes, chosen by M on the host against two constants set
// from measurement (kernels/qmm_crossover.py times the routes side by side):
//  * M < B16_MIN_ROWS (decode, M <= 2), `qmm_gemv<1>`: qmm_tile.cuh's
//    warp-per-row GEMV (scalar f32 FMAs, one warp per output column), one
//    pass over the weights per row.
//  * B16_MIN_ROWS <= M < STAGED_MIN_ROWS (batched decode, serving),
//    `qmm_b16_tile`: qmm_tc.cuh b16::, a weight-streaming bf16 tensor-core
//    tile that reads each weight word once for every row (128 columns and
//    16 or 32 rows a block, a ring of one group a stage, the k-range split
//    over a cluster where the column blocks leave SMs idle), with the f32
//    fold acc += d s + xs b of the plain version.
//  * M >= STAGED_MIN_ROWS (prefill), `qmm_staged_tile`: qmm_tc.cuh
//    staged::, the TPU's staged schedule on warpgroup MMAs over the
//    dequantized weight (bf16(q s + b) staged in shared memory, x .
//    bf16(q s + b) in f32), the rounding of the JAX package's XLA route.
// One launch a call on every route; a launch failure is returned.
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
#include "qmm_tc.cuh"
#include "qmm_tile.cuh"

namespace {

// Rows above take the int8 tile. Measured with both routes forced (PERF.md):
// at M = 1 the GEMV is 1.4-2.4x faster on every shape; at M = 2 it wins a
// Qwen3-4B layer's four projections together, at M = 3 the tile does (by a
// fifth; Qwen3-30B-A3B's qkv and o alone still favour the GEMV there), at
// M = 4 the tile wins on every shape.
constexpr int A8_GEMV_MAX_ROWS = 2;

// K1's routes by rows, set from `python -m tiny_llm_tpu_torch.kernels.
// qmm_crossover --kind k1` (PERF.md): a Qwen3-4B layer's four projections
// take less time on the GEMV at M = 2 and on the bf16 tile at M = 3; on the
// bf16 tile at M = 32 and on the staged tile at M = 48.
constexpr int B16_MIN_ROWS = 3;
constexpr int STAGED_MIN_ROWS = 33;

// One x row a block row (MT = 1, the only instance): rows blockIdx.y.
template <int MT>
__global__ void __launch_bounds__(256) qmm_gemv(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out,
    int M, int N, int Kp) {
  qmm::gemv_rows<MT>(x, w, s, b, res, out, blockIdx.y * MT, M, N, Kp);
}

// Grid (column blocks x ranks, row blocks), clusters of `ranks` blocks
// along x: the blocks of a cluster share one column block, each a k-range.
template <int MT>
__global__ void __launch_bounds__(qmm::b16::THREADS, 2) qmm_b16_tile(
    const __nv_bfloat16* __restrict__ x, const __grid_constant__ CUtensorMap wmap,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out, int M, int N,
    int Kp, int ranks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = qmm::b16::aligned(smem_raw);
  const int rank = blockIdx.x % ranks, n0 = blockIdx.x / ranks * qmm::b16::BN;
  const int m0 = blockIdx.y * 16 * MT, G = Kp / qmm::GS;
  float acc[MT][2][4] = {};
  qmm::b16::tile_mma<MT>(x, &wmap, s, b, m0, M, n0, N, Kp, rank * G / ranks,
                         (rank + 1) * G / ranks, smem, acc);
  qmm::b16::tile_store<MT>(acc, res, out, m0, M, n0, N, rank, ranks, smem);
}

template <int MT>
cudaError_t b16_route(const __nv_bfloat16* x, const uint32_t* w, const __nv_bfloat16* s,
                      const __nv_bfloat16* b, const __nv_bfloat16* res, __nv_bfloat16* out,
                      int M, int N, int Kp, cudaStream_t st) {
  constexpr int SMEM = qmm::b16::Shape<MT>::SMEM_BYTES;
  static const cudaError_t attr =
      cudaFuncSetAttribute(qmm_b16_tile<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap wmap;  // the weights in boxes of one group by 128 rows
  const cudaError_t e = qmm::tma::cached_weight_map(&wmap, w, N, Kp, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return e;
  const int cols = (N + qmm::b16::BN - 1) / qmm::b16::BN, rows = (M + 16 * MT - 1) / (16 * MT);
  const int ranks = qmm::cluster_ranks(Kp, cols * rows, qmm::a8::sm_count());
  return qmm::launch_clustered(qmm_b16_tile<MT>, dim3(cols * ranks, rows), qmm::b16::THREADS,
                               SMEM, ranks, st, x, wmap, s, b, res, out, M, N, Kp, ranks);
}

// Grid (column blocks x ranks, row blocks), clusters of `ranks` blocks
// along x, as qmm_b16_tile's.
__global__ void __launch_bounds__(qmm::staged::THREADS, 1) qmm_staged_tile(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out, int M, int N,
    int Kp, int ranks) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rank = blockIdx.x % ranks, G = Kp / qmm::GS;
  qmm::staged::tile(&xmap, &wmap, s, b, res, out, blockIdx.y * qmm::staged::BM,
                    blockIdx.x / ranks * qmm::staged::BN, M, N, Kp, rank * G / ranks,
                    (rank + 1) * G / ranks, rank, ranks, smem);
}

cudaError_t staged_route(const __nv_bfloat16* x, const uint32_t* w, const __nv_bfloat16* s,
                         const __nv_bfloat16* b, const __nv_bfloat16* res, __nv_bfloat16* out,
                         int M, int N, int Kp, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm_staged_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, qmm::staged::SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  CUtensorMap xmap, wmap;  // x changes every call: its map is encoded each time
  cudaError_t e = qmm::tma::encode_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, Kp, M,
                                      (uint64_t)Kp * 2, 64, qmm::staged::BM,
                                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)  // 64-byte swizzled, as the staged tile reads the words
    e = qmm::tma::cached_weight_map(&wmap, w, N, Kp, CU_TENSOR_MAP_SWIZZLE_64B);
  if (e != cudaSuccess) return e;
  const int cols = (N + qmm::staged::BN - 1) / qmm::staged::BN;
  const int rows = (M + qmm::staged::BM - 1) / qmm::staged::BM;
  const int ranks = qmm::cluster_ranks(Kp, cols * rows, qmm::a8::sm_count());
  return qmm::launch_clustered(qmm_staged_tile, dim3(cols * ranks, rows), qmm::staged::THREADS,
                               qmm::staged::SMEM_BYTES, ranks, st, xmap, wmap, s, b, res, out,
                               M, N, Kp, ranks);
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
  const int ranks = qmm::cluster_ranks(Kp, cols, qmm::a8::sm_count());
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
  if (M >= STAGED_MIN_ROWS) return (int)staged_route(xp, wp, sp, bp, rp, op, M, N, Kp, st);
  if (M >= B16_MIN_ROWS) {
    if (M <= 16) return (int)b16_route<1>(xp, wp, sp, bp, rp, op, M, N, Kp, st);
    return (int)b16_route<2>(xp, wp, sp, bp, rp, op, M, N, Kp, st);  // 32-row blocks
  }
  qmm_gemv<1><<<dim3((N + 7) / 8, M), dim3(256), 0, st>>>(xp, wp, sp, bp, rp, op, M, N, Kp);
  return (int)cudaGetLastError();
}

// K1's route for M rows: 0 the GEMV, 1 the bf16 tile, 2 the staged tile.
extern "C" int tlt_quant_matmul_route(int M) {
  return M >= STAGED_MIN_ROWS ? 2 : M >= B16_MIN_ROWS ? 1 : 0;
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
