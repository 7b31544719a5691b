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
// Design, two routes chosen by T on the host against B16_MIN_T (set from
// `python -m tiny_llm_tpu_torch.kernels.qmm_crossover --kind moe`); the
// grid stays fixed by T, N and E:
//  * T < B16_MIN_T (a decode step: one token's top-8), `moe_gemv`: grid
//    (N / 8, min(E, T)), block row j on the j-th expert that has rows, K1's
//    warp-per-output-row body (qmm_tile.cuh gemv_rows, through moe_walk.cuh
//    gemv_expert) over that expert's weights and rows, up to 8 rows per
//    pass over the weights, so at these rows it reads every weight once.
//  * Above, `moe_b16_tile`: K1's bf16 tensor-core tile (qmm_tc.cuh b16::,
//    HMMA, the weights by TMA, the f32 fold of the plain version) over the
//    logical tiles (expert, 16-row block of the expert's segment) in
//    expert order (moe_walk.cuh b16_tile_walk), 128 columns a block, so a
//    tile never holds two experts' rows and reads each weight once for its
//    rows. One tensor map covers the stacked weights as E N rows. Where the
//    column blocks of the fewest tiles T could make (every row on one
//    expert) leave SMs idle, the launch takes clusters, and where the
//    tiles there are (counted on the device) fit the SMs split over a
//    cluster, its blocks split each tile's k-range, as K1's do; otherwise
//    each block takes tiles of its own, over the whole k-range (the grid:
//    moe_walk.cuh b16_walk_grid). (The GEMV
//    reads an expert's weights once per 8 of its rows, and one expert's
//    rows keep one of its block rows busy.)
//
// The W4A8 walk, `tlt_grouped_quant_matmul_a8`, replaces _gqmm_pair_kernel
// (through _gqmm_pair_pallas) at its int8 shapes, T <= 128 grouped rows:
// per grouped row sx = max|x| / 127 over the row's K, xq = clip(rint(x /
// sx), ±127), and out = bf16( sx * sum_g (s_g (xq_g . q_g) + b_g sum xq_g) )
// with s32 integer dots and the fold in f32 (K1's W4A8 arithmetic, per
// expert). Bound: the active experts' weight bytes, as above. Two routes,
// chosen by T on the host (the grid stays fixed by T, N and E; the host
// never reads group_sizes):
//  * T <= 32 (up to four tokens' top-8: a decode step's 8), `moe_a8_gemv`:
//    the GEMV walk above on the W4A8 body (qmm_tile.cuh gemv_a8_rows): each
//    block quantizes its expert's rows, 8 at a time, into shared memory,
//    then runs __dp4a dots over 8 columns. With a row or two an expert,
//    its 96 column blocks an expert keep more bytes in flight than the
//    tile's 6 (N = 768): at T = 16 and 32 the tile loses on gate as much
//    as it gains on down (PERF.md), so the GEMV keeps these rows.
//  * 32 < T <= 128 (prompt tails, many tokens' top-8, skewed routing), the
//    int8 tensor-core tile (qmm_tile.cuh a8::): `moe_a8_quantize`
//    quantizes every row once into a workspace the wrapper allocates (its
//    size from tlt_grouped_quant_matmul_a8_workspace), then
//    `moe_a8_tile` walks the logical tiles (expert, 32-row block of its
//    segment) as moe_b16_tile does, 128 columns a block, reading each weight
//    once for the block's rows through a cp.async ring into mma.sync s8
//    (IMMA).
#include "moe_walk.cuh"

namespace {

constexpr int A8_GEMV_MAX_ROWS = 32;  // grouped rows above take the int8 tile walk

// W4A16 grouped rows at and above take the bf16 tile walk. Measured with
// both routes forced (qmm_crossover --kind moe, PERF.md): a MoE layer's
// gate, up and down under random top-8 routing take 1.33x as long on the
// tile walk at T = 8 (a decode step's 8 distinct experts), 1.21x at 9,
// 1.02x at 12 and less from 16; with one expert holding every row the GEMV
// walk takes 1.6-1.8x the tile walk's time from T = 8. A token always
// routes to 8 distinct experts, so T = 8 keeps the GEMV; above, the tile
// walk's worst loss (1.21x) is smaller than the GEMV's (1.8x).
constexpr int B16_MIN_T = 9;

// Grid (N / 8, min(E, T)): block row j serves the j-th expert that has rows.
__global__ void __launch_bounds__(256) moe_gemv(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const int* __restrict__ gs, __nv_bfloat16* __restrict__ out, int T, int N, int Kp, int E) {
  moe::gemv_expert(x, w, s, b, gs, out, T, N, Kp, E);
}

// Grid (column blocks x ranks, Y), clusters of `ranks` blocks along x:
// moe_walk.cuh b16_tile_walk.
__global__ void __launch_bounds__(qmm::b16::THREADS, 2) moe_b16_tile(
    const __nv_bfloat16* __restrict__ x, const __grid_constant__ CUtensorMap wmap,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const int* __restrict__ gs, __nv_bfloat16* __restrict__ out, int T, int N, int Kp, int E,
    int ranks, int cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  moe::b16_tile_walk(x, &wmap, s, b, gs, out, T, N, Kp, E, ranks, cap, smem_raw);
}

// The tile walk.
cudaError_t b16_walk(const __nv_bfloat16* x, const uint32_t* w, const __nv_bfloat16* s,
                     const __nv_bfloat16* b, const int* gs, __nv_bfloat16* out, int T, int N,
                     int Kp, int E, cudaStream_t st) {
  constexpr int SMEM = qmm::b16::Shape<1>::SMEM_BYTES;
  static const cudaError_t attr =
      cudaFuncSetAttribute(moe_b16_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap wmap;  // the experts' weights as E N rows, in boxes of one group by 128 rows
  const cudaError_t e =
      qmm::tma::cached_weight_map(&wmap, w, E * N, Kp, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return e;
  const moe::WalkGrid g = moe::b16_walk_grid(T, N, Kp, E);
  return qmm::launch_clustered(moe_b16_tile, g.grid, qmm::b16::THREADS, SMEM, g.ranks, st, x,
                               wmap, s, b, gs, out, T, N, Kp, E, g.ranks, g.cap);
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

// Row blockIdx.x of x into the workspace (qmm_tile.cuh a8::quantize_row).
__global__ void __launch_bounds__(1024) moe_a8_quantize(const __nv_bfloat16* __restrict__ x,
                                                       void* ws, int T, int Kp) {
  __shared__ float red[32];
  qmm::a8::let_dependents_launch();
  qmm::a8::quantize_row(x, blockIdx.x, T, Kp, qmm::a8::carve(ws, T, Kp), red);
}

// Grid (column blocks, Y): moe_walk.cuh a8_tile_walk.
__global__ void __launch_bounds__(qmm::a8::THREADS, 2) moe_a8_tile(
    void* ws, const uint32_t* __restrict__ w, const __nv_bfloat16* __restrict__ s,
    const __nv_bfloat16* __restrict__ b, const int* __restrict__ gs,
    __nv_bfloat16* __restrict__ out, int T, int N, int Kp, int E) {
  extern __shared__ __align__(16) unsigned char smem[];
  moe::a8_tile_walk(ws, w, s, b, gs, out, T, N, Kp, E, smem);
}

// The grouped W4A8 matmul: the GEMV walk up to A8_GEMV_MAX_ROWS rows, the
// tile walk above.
int a8_grouped(const void* x, const void* w, const void* s, const void* b,
               const void* group_sizes, void* out, int T, int N, int Kp, int E, void* ws,
               size_t ws_bytes, void* stream) {
  if (Kp % qmm::GS != 0 || T <= 0 || T > 128 || N <= 0 || E <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint32_t*>(w);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  const auto* bp = static_cast<const __nv_bfloat16*>(b);
  const auto* gp = static_cast<const int*>(group_sizes);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (T > A8_GEMV_MAX_ROWS) {
    if (ws == nullptr || ws_bytes < qmm::a8::workspace_bytes(T, Kp))
      return (int)cudaErrorInvalidValue;
    static const cudaError_t attr = cudaFuncSetAttribute(
        moe_a8_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, qmm::a8::SMEM_BYTES);
    if (attr != cudaSuccess) return (int)attr;
    moe_a8_quantize<<<T, qmm::a8::quantize_threads(Kp), 0, st>>>(xp, ws, T, Kp);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    // At most ceil(T / BM) + min(E, T) - 1 logical tiles; block rows enough
    // to fill the SMs twice over with the column blocks.
    const int cols = (N + qmm::a8::BN - 1) / qmm::a8::BN;
    const int tiles = (T + qmm::a8::BM - 1) / qmm::a8::BM + min(E, T) - 1;
    const int rows = max(1, min(tiles, (2 * qmm::a8::sm_count() + cols - 1) / cols));
    return (int)qmm::a8::launch_tile(moe_a8_tile, dim3(cols, rows), 1, st, ws, wp, sp, bp, gp,
                                     op, T, N, Kp, E);
  }
  static size_t allowed = 48 * 1024;  // raised once per size, not per launch
  const size_t smem = qmm::a8_smem_bytes(8, Kp);
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        moe_a8_gemv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  moe_a8_gemv<<<dim3((N + 7) / 8, min(E, T)), dim3(256), smem, st>>>(xp, wp, sp, bp, gp, op, T,
                                                                     N, Kp, E);
  return (int)cudaGetLastError();
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
  if (T >= B16_MIN_T) return (int)b16_walk(xp, wp, sp, bp, gp, op, T, N, Kp, E, st);
  moe_gemv<<<dim3((N + 7) / 8, min(E, T)), dim3(256), 0, st>>>(xp, wp, sp, bp, gp, op, T, N, Kp,
                                                               E);
  return (int)cudaGetLastError();
}

// The W4A16 entry's route for T rows: 0 the GEMV walk, 1 the bf16 tile walk.
extern "C" int tlt_grouped_quant_matmul_route(int T) { return T >= B16_MIN_T ? 1 : 0; }

// The tile walk's workspace for T rows of Kp, in bytes: 0 on the GEMV walk
// (T <= A8_GEMV_MAX_ROWS), where the entry takes none. The wrapper asks
// here, so the crossover lives in this file alone.
extern "C" size_t tlt_grouped_quant_matmul_a8_workspace(int T, int Kp) {
  return T > A8_GEMV_MAX_ROWS ? qmm::a8::workspace_bytes(T, Kp) : 0;
}

// ws: the workspace of the tile walk (tlt_grouped_quant_matmul_a8_workspace(
// T, Kp) bytes, 16-byte aligned), or null on the GEMV walk.
extern "C" int tlt_grouped_quant_matmul_a8(const void* x, const void* w, const void* s,
                                           const void* b, const void* group_sizes, void* out,
                                           int T, int N, int Kp, int E, void* ws,
                                           size_t ws_bytes, void* stream) {
  return a8_grouped(x, w, s, b, group_sizes, out, T, N, Kp, E, ws, ws_bytes, stream);
}
