// Grouped W4A16 group-128 expert matmul for Hopper (sm_90a): the MoE
// layers' gate, up and down projections.
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
// group_sizes stays on the device: each block finds its segment itself
// (warp prefix sums over group_sizes), so the host launches a grid fixed by
// T, N and E and never reads the sizes (the TPU computes its walk's
// metadata inside the jit, _group_metadata).
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
//    gemv_rows) over that expert's weights and rows, up to 8 rows per pass
//    over the weights. (A grid over all E experts, the empty ones exiting
//    at once, leaves 120 of 128 block rows idle at T = 8.)
//  * T > 64, `moe_tiled`: a walk over logical tiles (expert, 64-row block
//    of the expert's segment), each a 64x64 tensor-core tile (qmm_tile.cuh
//    tile) from the expert's first row, so a tile never holds two experts'
//    rows. The TPU walks global m-tiles instead, and an m-tile shared by
//    two experts carries its accumulator between two sequential grid
//    steps; here no carry and no atomics are needed, and there are at most
//    as many tiles as the TPU's tiles_m + E - 1 (sum ceil(c_e / 64) <=
//    ceil(T / 64) + E - 1). Invalid logical tiles exit.
#include "qmm_tile.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int GEMV_MAX_T = 64;  // rows at and below this take the GEMV schedule

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
// row if it has rows, or its 64-row tiles for the tile walk.
struct NonEmpty {
  __device__ int operator()(int start, int end) const { return end > start ? 1 : 0; }
};
struct RowTiles {
  __device__ int operator()(int start, int end) const {
    return (end - start + qmm::BM - 1) / qmm::BM;
  }
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

// Grid (N / 8, min(E, T)): block row j serves the j-th expert that has rows.
__global__ void __launch_bounds__(256) moe_gemv(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const int* __restrict__ gs, __nv_bfloat16* __restrict__ out, int T, int N, int Kp, int E) {
  __shared__ int meta[4];
  if (threadIdx.x < 32) find_unit(gs, E, T, blockIdx.y, NonEmpty{}, meta);
  __syncthreads();
  const int e = meta[0], start = meta[1], end = meta[2];
  if (e < 0) return;
  const size_t G = Kp / qmm::GS;
  const uint32_t* we = w + (size_t)e * N * (Kp / 8);
  const __nv_bfloat16* se = s + (size_t)e * N * G;
  const __nv_bfloat16* be = b + (size_t)e * N * G;
  if (end - start == 1) {
    qmm::gemv_rows<1>(x, we, se, be, nullptr, out, start, end, N, Kp);
  } else if (end - start <= 4) {
    qmm::gemv_rows<4>(x, we, se, be, nullptr, out, start, end, N, Kp);
  } else {
    for (int m0 = start; m0 < end; m0 += 8)
      qmm::gemv_rows<8>(x, we, se, be, nullptr, out, m0, end, N, Kp);
  }
}

// Grid (N / 64, tiles_m + E - 1): block row i is logical tile i, the
// (expert, 64-row block) pairs in expert order.
__global__ void __launch_bounds__(128) moe_tiled(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const int* __restrict__ gs, __nv_bfloat16* __restrict__ out, int T, int N, int Kp, int E) {
  __shared__ int meta[4];
  if (threadIdx.x < 32) find_unit(gs, E, T, blockIdx.y, RowTiles{}, meta);
  __syncthreads();
  const int e = meta[0];
  if (e < 0) return;
  const size_t G = Kp / qmm::GS;
  qmm::tile(x, w + (size_t)e * N * (Kp / 8), s + (size_t)e * N * G, b + (size_t)e * N * G,
            nullptr, out, meta[1] + meta[3] * qmm::BM, blockIdx.x * qmm::BN, meta[2], N, Kp);
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
  if (T <= GEMV_MAX_T) {
    moe_gemv<<<dim3((N + 7) / 8, min(E, T)), dim3(256), 0, st>>>(xp, wp, sp, bp, gp, op, T, N,
                                                                 Kp, E);
  } else {
    const int tiles_m = (T + qmm::BM - 1) / qmm::BM;
    moe_tiled<<<dim3((N + qmm::BN - 1) / qmm::BN, tiles_m + E - 1), dim3(128), 0, st>>>(
        xp, wp, sp, bp, gp, op, T, N, Kp, E);
  }
  return (int)cudaGetLastError();
}
