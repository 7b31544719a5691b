// The grouped expert matmuls' walks over experts (moe_matmul.cu,
// moe_matmul_sg.cu): rows x [T, Kp] sorted by expert, expert e owning the
// segment [goffs[e], goffs[e + 1]) with goffs the exclusive prefix sum of
// group_sizes [E]. group_sizes stays on the device: each block finds its
// unit (an expert that has rows, or an (expert, row block) tile) itself,
// by warp prefix sums over group_sizes, so the host launches a grid fixed
// by T, N and E and never reads the sizes (the TPU computes its walk's
// metadata inside the jit, _group_metadata).
#pragma once

#include "qmm_tc.cuh"
#include "qmm_tile.cuh"

namespace moe {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// The units of work an expert with rows [start, end) owns: one GEMV block
// row if it has rows.
struct NonEmpty {
  __device__ int operator()(int start, int end) const { return end > start ? 1 : 0; }
};

// Run by warp 0: which expert owns unit i, when the experts own units(start,
// end) consecutive units each, in expert order (as the TPU's _group_metadata
// numbers its logical tiles).
// Writes meta = {expert (-1: no expert owns unit i), start, end (clamped to
// T), i's index among the expert's units}. Scans group_sizes 32 experts at a
// time with warp prefix sums.
template <class Units>
__device__ __forceinline__ void find_unit(const int* __restrict__ gs, int E, int T, int i,
                                          Units units, int* meta) {
  const int lane = threadIdx.x & 31;
  int rows = 0, done = 0;
  bool found = false;
  for (int c = 0; c < E && !found; c += 32) {
    const int e = c + lane;
    const int sz = e < E ? __ldg(gs + e) : 0;
    const int incl = warp_incl_scan(sz);
    const int start = rows + incl - sz, end = rows + incl;
    const int u = units(start, end);
    const int incl_u = warp_incl_scan(u);
    const int first = done + incl_u - u;
    const unsigned hit = __ballot_sync(FULL, u > 0 && i >= first && i < first + u);
    if (hit) {
      if (lane == __ffs(hit) - 1) {
        meta[0] = e;
        meta[1] = start;
        meta[2] = min(end, T);
        meta[3] = i - first;
      }
      found = true;
    }
    rows += __shfl_sync(FULL, incl, 31);
    done += __shfl_sync(FULL, incl_u, 31);
  }
  if (lane == 0 && !found) meta[0] = -1;
}

// Row bodies for gemv_expert (W4 g128): rows [m0, min(m0 + MT, end)) of
// out from one expert's weights. The bf16 body is K1's GEMV; the W4A8 body
// quantizes the rows into `smem` first (qmm_tile.cuh).
struct Bf16Rows {
  template <int MT>
  __device__ __forceinline__ void run(const __nv_bfloat16* x, const uint32_t* w,
                                      const __nv_bfloat16* s, const __nv_bfloat16* b,
                                      __nv_bfloat16* out, int m0, int end, int N,
                                      int Kp) const {
    qmm::gemv_rows<MT>(x, w, s, b, nullptr, out, m0, end, N, Kp);
  }
};
struct A8Rows {
  unsigned char* smem;  // qmm::a8_smem_bytes(8, Kp) bytes
  template <int MT>
  __device__ __forceinline__ void run(const __nv_bfloat16* x, const uint32_t* w,
                                      const __nv_bfloat16* s, const __nv_bfloat16* b,
                                      __nv_bfloat16* out, int m0, int end, int N,
                                      int Kp) const {
    qmm::gemv_a8_rows<MT>(x, w, s, b, nullptr, out, m0, end, N, Kp, smem);
  }
};

// Block row j of a grid (N / 8, min(E, T)) serves the j-th expert that has
// rows: `rows`' warp-per-output-row GEMV over that expert's weights and
// rows, up to 8 rows per pass over the weights. 256 threads.
template <class Rows = Bf16Rows>
__device__ __forceinline__ void gemv_expert(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const int* __restrict__ gs, __nv_bfloat16* __restrict__ out, int T, int N, int Kp, int E,
    Rows rows = Rows{}) {
  __shared__ int meta[4];
  if (threadIdx.x < 32) find_unit(gs, E, T, blockIdx.y, NonEmpty{}, meta);
  __syncthreads();
  const int e = meta[0], start = meta[1], end = meta[2];
  if (e < 0) return;  // the whole block: meta is shared
  const size_t G = Kp / qmm::GS;
  const uint32_t* we = w + (size_t)e * N * (Kp / 8);
  const __nv_bfloat16* se = s + (size_t)e * N * G;
  const __nv_bfloat16* be = b + (size_t)e * N * G;
  if (end - start == 1) {
    rows.template run<1>(x, we, se, be, out, start, end, N, Kp);
  } else if (end - start <= 4) {
    rows.template run<4>(x, we, se, be, out, start, end, N, Kp);
  } else {
    for (int m0 = start; m0 < end; m0 += 8)
      rows.template run<8>(x, we, se, be, out, m0, end, N, Kp);
  }
}

// Run by warp 0: find_unit's answer for units of R-row blocks, with every
// group size loaded before the scan (128 experts a pass), so a lookup
// waits for one load, not one a 32 experts.
template <int R>
__device__ __forceinline__ void find_row_block(const int* __restrict__ gs, int E, int T, int i,
                                               int* meta) {
  const int lane = threadIdx.x & 31;
  int rows = 0, done = 0;
  for (int c0 = 0; c0 < E; c0 += 128) {
    int sz[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = c0 + 32 * k + lane;
      sz[k] = e < E ? __ldg(gs + e) : 0;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int incl = warp_incl_scan(sz[k]);
      const int start = rows + incl - sz[k], end = rows + incl;
      const int u = (sz[k] + R - 1) / R;
      const int incl_u = warp_incl_scan(u);
      const int first = done + incl_u - u;
      const unsigned hit = __ballot_sync(FULL, u > 0 && i >= first && i < first + u);
      if (hit) {
        if (lane == __ffs(hit) - 1) {
          meta[0] = c0 + 32 * k + lane;
          meta[1] = start;
          meta[2] = min(end, T);
          meta[3] = i - first;
        }
        return;
      }
      rows += __shfl_sync(FULL, incl, 31);
      done += __shfl_sync(FULL, incl_u, 31);
    }
  }
  if (lane == 0) meta[0] = -1;
}

// Block row j of a grid (column blocks, Y) walks the logical tiles j, j +
// Y, ... (the (expert, BM-row block) pairs in expert order) on the W4A8
// tile (qmm_tile.cuh a8::) over rows quantized into `ws`, the whole
// k-range a block. THREADS threads, SMEM_BYTES of dynamic shared memory.
__device__ __forceinline__ void a8_tile_walk(
    void* ws, const uint32_t* __restrict__ w, const __nv_bfloat16* __restrict__ s,
    const __nv_bfloat16* __restrict__ b, const int* __restrict__ gs,
    __nv_bfloat16* __restrict__ out, int T, int N, int Kp, int E, unsigned char* smem) {
  namespace a8 = qmm::a8;
  __shared__ int meta[4];
  const a8::Quantized q = a8::carve(ws, T, Kp);
  const int n0 = blockIdx.x * a8::BN, G = Kp / qmm::GS;
  for (int i = blockIdx.y;; i += gridDim.y) {
    if (threadIdx.x < 32) find_row_block<a8::BM>(gs, E, T, i, meta);
    __syncthreads();
    const int e = meta[0], m0 = meta[1] + meta[3] * a8::BM, end = meta[2];
    if (e < 0) return;
    a8::Acc acc = {};
    a8::tile_mma(q, T, w + (size_t)e * N * (Kp / 8), s + (size_t)e * N * G,
                 b + (size_t)e * N * G, m0, end, n0, N, Kp, 0, G, smem, acc);
    a8::tile_store(acc, nullptr, out, m0, end, n0, N, 0, 1, smem);
  }
}

// Run by warp 0: the logical tiles of R-row blocks over all E experts.
template <int R>
__device__ __forceinline__ int count_row_blocks(const int* __restrict__ gs, int E) {
  int n = 0;
  for (int e = threadIdx.x & 31; e < E; e += 32) n += (__ldg(gs + e) + R - 1) / R;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(FULL, n, o);
  return n;
}

// A grid (column blocks x ranks, Y), clusters of `ranks` blocks along x,
// walks the logical tiles (the (expert, 16-row block) pairs in expert
// order) on K1's bf16 tile (qmm_tc.cuh b16::, the f32 fold of the plain
// version; 16 rows a tile: 32-row tiles, with two fewer ring stages, took
// 10-25 % longer at T = 24 to 1024 under random routing, PERF.md) at the
// experts' width (BITS, GSZ; row 17's bodies; K1's W4 g128 by default):
// tile (e, i) takes the expert's rows [m0, m0 + 16) below its segment's
// end against its weights, rows e N + n0.. of `wmap` (the stacked weights
// as E N rows in boxes of BN rows, tma::weight_map in row_swizzle(BITS)
// other than K1's). An expert's scales and biases are N (Kp / GSZ) apart;
// the k-range splits over 128-code stages (Kp / KU of them), which are
// groups only at g128. Every block counts the tiles (the group sizes live
// on the device) and so picks the same schedule:
//  * where every tile's blocks, split over the cluster, fit the `cap`
//    blocks the SMs hold at once (few tiles: skewed routing), block row j
//    walks tiles j, j + Y, ..., the cluster's blocks each a k-range, their
//    partial tiles added as K1's are;
//  * otherwise each block walks tiles alone over the whole k-range, block
//    (rank, j) taking tiles j ranks + rank, + Y ranks, ....
// b16::THREADS threads, Shape<1, BITS, GSZ>::SMEM_BYTES of dynamic shared
// memory.
template <int BITS = 4, int GSZ = qmm::GS>
__device__ __forceinline__ void b16_tile_walk(
    const __nv_bfloat16* __restrict__ x, const CUtensorMap* wmap,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const int* __restrict__ gs, __nv_bfloat16* __restrict__ out, int T, int N, int Kp, int E,
    int ranks, int cap, unsigned char* smem_raw) {
  namespace b16 = qmm::b16;
  using S = b16::Shape<1, BITS, GSZ>;
  __shared__ int meta[4], ntiles;
  unsigned char* smem = b16::aligned_to<b16::Width<BITS, GSZ>::ALIGN>(smem_raw);
  if (threadIdx.x < 32) {
    const int n = count_row_blocks<S::BM>(gs, E);
    if (threadIdx.x == 0) ntiles = n;
  }
  __syncthreads();
  const bool split_k = ranks > 1 && (long long)ntiles * gridDim.x <= cap;
  const int nrank = split_k ? ranks : 1, rank = split_k ? blockIdx.x % ranks : 0;
  const int first = split_k ? blockIdx.y : blockIdx.y * ranks + blockIdx.x % ranks;
  const int stride = split_k ? gridDim.y : gridDim.y * ranks;
  const int n0 = blockIdx.x / ranks * b16::BN, G = Kp / qmm::KU, GE = Kp / GSZ;
  for (int i = first; i < ntiles; i += stride) {  // the whole cluster leaves together when split
    if (threadIdx.x < 32) find_row_block<S::BM>(gs, E, T, i, meta);
    __syncthreads();
    const int e = meta[0], m0 = meta[1] + meta[3] * S::BM, end = meta[2];
    float acc[1][2][4] = {};
    b16::tile_mma<1, BITS, GSZ>(x, wmap, s + (size_t)e * N * GE, b + (size_t)e * N * GE, m0,
                                end, n0, N, Kp, rank * G / nrank, (rank + 1) * G / nrank, smem,
                                acc, e * N);
    b16::tile_store<1>(acc, nullptr, out, m0, end, n0, N, rank, nrank, smem);
    // The next tile: its mbarriers initialized afresh, and its TMA writes
    // into the ring after this tile's partial tile there (generic writes).
    fmma::fence_proxy_async();
    if (threadIdx.x == 0)
      for (int k = 0; k < S::STAGES; ++k) qmm::tma::inval(smem_u32(smem + S::BARS) + 8 * k);
  }
}

// The tile walk's grid on the host (moe_matmul.cu, moe_matmul_sg.cu):
// clusters sized for the fewest tiles T can make (one expert holding every
// row), block rows enough that each block walks one tile when there are
// the most (a row an expert), at most GRID_BLOCKS_PER_SM blocks a SM in
// all, the rest walking more tiles each; the walk takes the k-split where
// the tiles' split blocks number at most SPLIT_BLOCKS_PER_SM a SM (more,
// and a 768-column gate at T = 8 over 8 experts took 2.5x as long; a sweep
// of 2, 4, 8 and 4, 8, unbounded on this card, PERF.md).
constexpr int SPLIT_BLOCKS_PER_SM = 2;
constexpr int GRID_BLOCKS_PER_SM = 4;

struct WalkGrid {
  dim3 grid;
  int ranks, cap;  // blocks a cluster; the walk's k-split bound (b16_tile_walk `cap`)
};

inline WalkGrid b16_walk_grid(int T, int N, int Kp, int E) {
  constexpr int BM = qmm::b16::Shape<1>::BM;  // 16 rows a tile at every width
  const int cols = (N + qmm::b16::BN - 1) / qmm::b16::BN, sms = qmm::a8::sm_count();
  const int least = (T + BM - 1) / BM, most = least + std::min(E, T) - 1;  // logical tiles
  const int ranks = qmm::cluster_ranks(Kp, cols * least, sms);
  const int rows = std::max(1, std::min((most + ranks - 1) / ranks,
                                        GRID_BLOCKS_PER_SM * sms / (cols * ranks)));
  return {dim3(cols * ranks, rows), ranks, SPLIT_BLOCKS_PER_SM * sms};
}

}  // namespace moe
