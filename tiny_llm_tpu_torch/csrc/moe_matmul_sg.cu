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
// Weights: packed int32 [E, N, Kp BITS / 32], scales/biases bf16
// [E, N, Kp / GSZ].
//
// Bound on the H100: the active experts' weight bytes (BITS / 8 B per
// weight plus 4 B per group) plus x and out, over 3.35 TB/s — at a decode
// step of Qwen3-30B-A3B W4 g64 (T = 8 rows over 8 experts) ~7 MB and ~2 us
// per gate, up or down call; the bf16 tensor-core rate only when many rows
// share an expert.
//
// Design, two routes chosen by T on the host against SG_B16_MIN_T (set
// from `python -m tiny_llm_tpu_torch.kernels.qmm_crossover --kind moe_sg`);
// the grid stays fixed by T, N and E, and the host never reads the sizes:
//  * T < SG_B16_MIN_T (decode steps: a token's top-8 is T = 8),
//    `moe_sg_gemv`: a GEMV walk over (expert that has rows, column block)
//    units, grid (N / columns a block, min(E, T)). Warp 0 finds the
//    block's expert with one load of up to 128 group sizes before its scan
//    (moe_walk.cuh find_row_block).
//    Each column takes `tpc` consecutive lanes (the fewest, 4 to 32, that
//    hold its 16-byte weight chunks in GEMV_CHUNKS loads each: K = 768 at
//    W4 is 24 chunks on 4 lanes, K = 2048 64 chunks on 8), lane p reading
//    chunks p, p + tpc, ... so the column's lanes read contiguous bytes,
//    every chunk of a batch in flight before the first product. The codes
//    become floats without a conversion instruction (W2 / W4: the bf16 pair
//    128 + q of two codes, qmm_tc.cuh's magic, split into two f32; W8: the
//    f32 2^23 + q from one byte permute, less 2^23), against x rows the
//    block staged once as f32 in shared memory (padded per chunk so a
//    column's lanes hit distinct banks) with each group part's x sum; the
//    scales and biases of the block's columns arrive by 16-byte loads into
//    shared memory. Per group part and x row: d' = x . (c + q), then acc +=
//    d' s + xs (b - c s) in f32 (c = 128, or 0 at W8). The column's lanes
//    add their sums by shuffles. Up to PASS_ROWS x rows share one pass over
//    the weights (an expert with more rows takes more passes).
//  * Above, `moe_sg_b16_tile`: row 18's tile walk (moe_walk.cuh
//    b16_tile_walk: K1's bf16 tensor-core tile over (expert, 16-row block)
//    tiles in expert order, HMMA, the weights by one TMA map over E N rows,
//    the k-split over a cluster where the tiles are few) on row 17's bodies
//    at the experts' width (qmm_tc.cuh b16:: with BITS, GSZ).
// One launch a call on both routes; a launch failure is returned.
#include "moe_walk.cuh"

namespace {

// Grouped rows at and above take the tile walk. Measured with both routes
// forced (qmm_crossover --kind moe_sg, PERF.md), 30B-A3B gate and down at
// W4 g64 and W8 g64, T = 8 to 1024, under the two routings a top-8 router
// bounds: random top-8, and one expert in every token's top-8 (T / 8 rows
// on it, the most an expert gets). The two read within 1.1x of each other;
// the GEMV wins to T = 96 (the tile takes 1.04-2.6x its time), the tile
// from 256 (the GEMV 1.05-1.4x there, 3.4x at 1024). Of the rows measured,
// a gate at 192 bounds the loss at 1.07x (128: 1.17x, 256: 1.12x). From the
// gate on, the tiles are too many for the walk's k-split (b16_walk_grid).
constexpr int SG_B16_MIN_T = 192;
// The GEMV walk's block, the 16-byte chunks a lane loads a batch (the
// k-split: each column gets the fewest lanes that hold its chunks in one
// batch) and the x rows a pass stages. Set by `qmm_crossover --kind
// moe_sg_gemv` (PERF.md): of 128, 256 and 512 threads by 2, 4 and 8
// chunks, under random top-8, 128 x 8 took within 1.03x of the least at a
// decode step (T = 8) in one sweep and 1.26x (W8 gate) in a second, at
// most 1.39x the best elsewhere to T = 16 and 1.08x at T = 32 and 64; a
// tie with 256 x 4 (worst 1.34x), 256 x 8 at most 1.47x.
constexpr int GEMV_THREADS = 128;
constexpr int GEMV_CHUNKS = 8;
constexpr int PASS_ROWS = 4;
// 1 only in the copy that `qmm_crossover --kind moe_sg_gemv` times beside
// moe_matmul.cu's W4 g128 GEMV: this file's routes at W4 g128 too.
constexpr int SIDE_W4G128 = 0;

// A 16-byte chunk of a weight row at a width.
template <int BITS, int GSZ>
struct Chunk {
  static constexpr int CPW = 32 / BITS;                // codes a word
  static constexpr int CPC = 4 * CPW;                  // codes a chunk: 64, 32 or 16
  static constexpr int PART = CPC < GSZ ? CPC : GSZ;   // codes of one group in a chunk
  static constexpr int NG = CPC / PART;                // group parts a chunk: 2 at W2 g32
  static constexpr int WPP = PART / CPW;               // words a group part
  static constexpr int XLD = CPC + 4;                  // f32 x slots a chunk (16 bytes pad)
  static constexpr float OFFSET = BITS == 8 ? 0.f : 128.f;  // c of d' = x . (c + q)

  // Word w's codes as floats in k order: W2 / W4 c + q (the bf16 pairs
  // (c + q_j, c + q_{j + CPW / 2}) split into f32), W8 q.
  static __device__ __forceinline__ void codes(uint32_t w, float (&v)[CPW]) {
    if constexpr (BITS == 8) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = __uint_as_float(__byte_perm(w, 0x4Bu, 0x4550u | j)) - 8388608.f;
    } else {
      constexpr uint32_t MASK = BITS == 4 ? 0x000F000Fu : 0x00030003u;
#pragma unroll
      for (int j = 0; j < CPW / 2; ++j) {
        const uint32_t m = ((w >> (BITS * j)) & MASK) | 0x43004300u;
        v[j] = __uint_as_float(m << 16);
        v[j + CPW / 2] = __uint_as_float(m & 0xFFFF0000u);
      }
    }
  }
};

// Shared memory of the GEMV walk: per column its groups' (s | b << 16),
// rows of G + 1 words; per staged x row its group parts' x sums; the x
// rows as f32, chunk by chunk, XLD slots a chunk.
struct GemvSmem {
  uint32_t* sb;
  float* xsum;
  float* xf;
};

// The x rows staged for passes of `rows` rows: the rows of the chunk_rows
// instance that runs them (1, 2 or PASS_ROWS).
__host__ __device__ constexpr int staged_rows(int rows) { return rows <= 2 ? rows : PASS_ROWS; }

__host__ __device__ inline size_t gemv_smem_bytes(int cols, int G, int nparts, int nch, int xld,
                                                  int rows) {
  const int sr = staged_rows(rows);
  return (size_t)cols * (G + 1) * 4 + (size_t)sr * nparts * 4 + (size_t)sr * nch * xld * 4 + 16;
}

// MT staged x rows (those past the pass's rows hold stale values, whose
// sums are never stored) against the lane's chunk c of its column's
// weights (wv), added into acc.
template <class Ck, int MT>
__device__ __forceinline__ void chunk_rows(const uint4& wv, int c, const uint32_t* sbr,
                                           const GemvSmem& sm, int nch, int nparts, int GSZ_LOG,
                                           float (&acc)[PASS_ROWS]) {
  const uint32_t words[4] = {wv.x, wv.y, wv.z, wv.w};
  const int g0 = (c * Ck::CPC) >> GSZ_LOG;  // the chunk's first group
#pragma unroll
  for (int gp = 0; gp < Ck::NG; ++gp) {
    float d[MT];
#pragma unroll
    for (int r = 0; r < MT; ++r) d[r] = 0.f;
#pragma unroll
    for (int wi = gp * Ck::WPP; wi < (gp + 1) * Ck::WPP; ++wi) {
      float v[Ck::CPW];
      Ck::codes(words[wi], v);
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const float4* xr =
            reinterpret_cast<const float4*>(sm.xf + ((size_t)r * nch + c) * Ck::XLD + wi * Ck::CPW);
#pragma unroll
        for (int k4 = 0; k4 < Ck::CPW / 4; ++k4) {
          const float4 xv = xr[k4];
          d[r] += xv.x * v[4 * k4] + xv.y * v[4 * k4 + 1] + xv.z * v[4 * k4 + 2] +
                  xv.w * v[4 * k4 + 3];
        }
      }
    }
    const uint32_t sbv = sbr[g0 + gp];
    const float sc = lo_bf16(sbv), cb = hi_bf16(sbv) - Ck::OFFSET * sc;
#pragma unroll
    for (int r = 0; r < MT; ++r) acc[r] += d[r] * sc + sm.xsum[r * nparts + c * Ck::NG + gp] * cb;
  }
}

// Grid (column blocks, min(E, T)): block row j serves the j-th expert that
// has rows, `GEMV_THREADS >> tpc_log2` columns a block, `rows_cap` (at
// most PASS_ROWS) x rows staged a pass.
template <int BITS, int GSZ>
__global__ void __launch_bounds__(GEMV_THREADS) moe_sg_gemv(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const int* __restrict__ gs, __nv_bfloat16* __restrict__ out, int T, int N, int Kp, int E,
    int tpc_log2, int rows_cap) {
  using Ck = Chunk<BITS, GSZ>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int meta[4];
  if (threadIdx.x < 32) moe::find_row_block<1 << 30>(gs, E, T, blockIdx.y, meta);
  __syncthreads();
  const int e = meta[0], start = meta[1], end = meta[2];
  if (e < 0) return;  // the whole block: meta is shared

  const int tid = threadIdx.x, tpc = 1 << tpc_log2, cols = GEMV_THREADS >> tpc_log2;
  const int col = tid >> tpc_log2, p = tid & (tpc - 1);
  const int n0 = blockIdx.x * cols, n = n0 + col, ncols = min(cols, N - n0);
  const int G = Kp / GSZ, nch = Kp / Ck::CPC, nparts = nch * Ck::NG;
  constexpr int GSZ_LOG = qmm::ilog2(GSZ);
  GemvSmem sm;
  sm.sb = reinterpret_cast<uint32_t*>(smem);
  sm.xsum = reinterpret_cast<float*>(sm.sb + (size_t)cols * (G + 1));
  sm.xf = sm.xsum + (size_t)staged_rows(rows_cap) * nparts;
  sm.xf += (16 - (reinterpret_cast<uintptr_t>(sm.xf) & 15)) / 4 % 4;  // float4-aligned
  const uint4* wrow = reinterpret_cast<const uint4*>(
      w + ((size_t)e * N + min(n, N - 1)) * (Kp / Ck::CPW));

  uint4 wv[GEMV_CHUNKS];
  auto load = [&](int j0) {  // the lane's chunks p + tpc (j0 + u)
#pragma unroll
    for (int u = 0; u < GEMV_CHUNKS; ++u) {
      const int c = p + tpc * (j0 + u);
      wv[u] = c < nch ? __ldg(wrow + c) : make_uint4(0, 0, 0, 0);
    }
  };
  load(0);

  // The block's scales and biases, by 16-byte loads where they align.
  {
    const size_t base = ((size_t)e * N + n0) * G;
    const int span = ncols * G;
    if ((base & 7) == 0 && (span & 7) == 0) {
      const uint4* s4 = reinterpret_cast<const uint4*>(s + base);
      const uint4* b4 = reinterpret_cast<const uint4*>(b + base);
      for (int i = tid; i < span / 8; i += GEMV_THREADS) {
        const uint4 sv = __ldg(s4 + i), bv = __ldg(b4 + i);
        const uint32_t sw[4] = {sv.x, sv.y, sv.z, sv.w}, bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int idx = 8 * i + q, cc = idx / G, g = idx - cc * G;
          sm.sb[cc * (G + 1) + g] = ((sw[q / 2] >> (16 * (q & 1))) & 0xFFFFu) |
                                    (((bw[q / 2] >> (16 * (q & 1))) & 0xFFFFu) << 16);
        }
      }
    } else {
      for (int idx = tid; idx < span; idx += GEMV_THREADS) {
        const int cc = idx / G, g = idx - cc * G;
        sm.sb[cc * (G + 1) + g] = (uint32_t)__bfloat16_as_ushort(s[base + idx]) |
                                  ((uint32_t)__bfloat16_as_ushort(b[base + idx]) << 16);
      }
    }
  }

  const uint32_t* sbr = sm.sb + (size_t)min(col, max(ncols - 1, 0)) * (G + 1);
  for (int m0 = start; m0 < end; m0 += rows_cap) {
    const int nr = min(rows_cap, end - m0);
    if (m0 > start) {
      __syncthreads();  // the last pass has read the staged rows
      load(0);
    }
    // Rows m0.. as f32 in chunk order, with each group part's x sum.
    for (int i = tid; i < nr * nparts; i += GEMV_THREADS) {
      const int r = i / nparts, pp = i - r * nparts, c = pp / Ck::NG, gp = pp - c * Ck::NG;
      const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * Kp +
                                                        (size_t)pp * Ck::PART);
      float4* dst = reinterpret_cast<float4*>(sm.xf + ((size_t)r * nch + c) * Ck::XLD +
                                              gp * Ck::PART);
      float sum = 0.f;
#pragma unroll
      for (int k8 = 0; k8 < Ck::PART / 8; ++k8) {
        const uint4 v = __ldg(src + k8);
        const float4 a = make_float4(lo_bf16(v.x), hi_bf16(v.x), lo_bf16(v.y), hi_bf16(v.y));
        const float4 z = make_float4(lo_bf16(v.z), hi_bf16(v.z), lo_bf16(v.w), hi_bf16(v.w));
        dst[2 * k8] = a;
        dst[2 * k8 + 1] = z;
        sum += ((a.x + a.y) + (a.z + a.w)) + ((z.x + z.y) + (z.z + z.w));
      }
      sm.xsum[r * nparts + pp] = sum;
    }
    __syncthreads();

    float acc[PASS_ROWS] = {};
    for (int j0 = 0; p + tpc * j0 < nch; j0 += GEMV_CHUNKS) {
      if (j0 > 0) load(j0);
#pragma unroll
      for (int u = 0; u < GEMV_CHUNKS; ++u) {
        const int c = p + tpc * (j0 + u);
        if (c < nch) {
          if (nr == 1) {
            chunk_rows<Ck, 1>(wv[u], c, sbr, sm, nch, nparts, GSZ_LOG, acc);
          } else if (nr == 2) {
            chunk_rows<Ck, 2>(wv[u], c, sbr, sm, nch, nparts, GSZ_LOG, acc);
          } else {
            chunk_rows<Ck, PASS_ROWS>(wv[u], c, sbr, sm, nch, nparts, GSZ_LOG, acc);
          }
        }
      }
    }
    // The column's lanes are consecutive: add their sums by shuffles.
#pragma unroll
    for (int r = 0; r < PASS_ROWS; ++r) {
      float v = acc[r];
      for (int o = tpc >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(moe::FULL, v, o);
      if (p == 0 && r < nr && col < ncols)
        out[(size_t)(m0 + r) * N + n] = __float2bfloat16_rn(v);
    }
  }
}

template <int BITS, int GSZ>
cudaError_t gemv_walk(const __nv_bfloat16* x, const uint32_t* w, const __nv_bfloat16* s,
                      const __nv_bfloat16* b, const int* gs, __nv_bfloat16* out, int T, int N,
                      int Kp, int E, cudaStream_t st) {
  using Ck = Chunk<BITS, GSZ>;
  const int nch = Kp / Ck::CPC;
  int tpc_log2 = 2;  // the fewest lanes, 4 to 32, that hold a column's chunks in one batch
  while (tpc_log2 < 5 && ((nch + (1 << tpc_log2) - 1) >> tpc_log2) > GEMV_CHUNKS) ++tpc_log2;
  const int cols = GEMV_THREADS >> tpc_log2, rows_cap = min(T, PASS_ROWS);
  const size_t smem = gemv_smem_bytes(cols, Kp / GSZ, nch * Ck::NG, nch, Ck::XLD, rows_cap);
  static size_t allowed = 48 * 1024;  // raised once per size, not per launch
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        moe_sg_gemv<BITS, GSZ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  moe_sg_gemv<BITS, GSZ><<<dim3((N + cols - 1) / cols, min(E, T)), GEMV_THREADS, smem, st>>>(
      x, w, s, b, gs, out, T, N, Kp, E, tpc_log2, rows_cap);
  return cudaGetLastError();
}

// Grid (column blocks x ranks, Y), clusters of `ranks` blocks along x:
// moe_walk.cuh b16_tile_walk at the width.
template <int BITS, int GSZ>
__global__ void __launch_bounds__(qmm::b16::THREADS, 2) moe_sg_b16_tile(
    const __nv_bfloat16* __restrict__ x, const __grid_constant__ CUtensorMap wmap,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const int* __restrict__ gs, __nv_bfloat16* __restrict__ out, int T, int N, int Kp, int E,
    int ranks, int cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  moe::b16_tile_walk<BITS, GSZ>(x, &wmap, s, b, gs, out, T, N, Kp, E, ranks, cap, smem_raw);
}

template <int BITS, int GSZ>
cudaError_t b16_walk(const __nv_bfloat16* x, const uint32_t* w, const __nv_bfloat16* s,
                     const __nv_bfloat16* b, const int* gs, __nv_bfloat16* out, int T, int N,
                     int Kp, int E, cudaStream_t st) {
  constexpr int SMEM = qmm::b16::Shape<1, BITS, GSZ>::SMEM_BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      moe_sg_b16_tile<BITS, GSZ>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap wmap;  // the experts' weights as E N rows, in boxes of one stage by 128 rows
  const cudaError_t e =
      qmm::tma::cached_weight_map(&wmap, w, E * N, Kp, qmm::tma::row_swizzle(BITS), BITS);
  if (e != cudaSuccess) return e;
  const moe::WalkGrid g = moe::b16_walk_grid(T, N, Kp, E);
  return qmm::launch_clustered(moe_sg_b16_tile<BITS, GSZ>, g.grid, qmm::b16::THREADS, SMEM,
                               g.ranks, st, x, wmap, s, b, gs, out, T, N, Kp, E, g.ranks, g.cap);
}

template <int BITS, int GSZ>
cudaError_t launch(const __nv_bfloat16* x, const uint32_t* w, const __nv_bfloat16* s,
                   const __nv_bfloat16* b, const int* gs, __nv_bfloat16* out, int T, int N,
                   int Kp, int E, cudaStream_t st) {
  if (T >= SG_B16_MIN_T) return b16_walk<BITS, GSZ>(x, w, s, b, gs, out, T, N, Kp, E, st);
  return gemv_walk<BITS, GSZ>(x, w, s, b, gs, out, T, N, Kp, E, st);
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
#define TLT_SG_CASE(B, G) \
  case B * 1000 + G:      \
    return (int)launch<B, G>(xp, wp, sp, bp, gp, op, T, N, Kp, E, st);
  switch (bits * 1000 + group_size) {
    TLT_SG_CASE(2, 32) TLT_SG_CASE(2, 64) TLT_SG_CASE(2, 128)
    TLT_SG_CASE(4, 32) TLT_SG_CASE(4, 64)
    TLT_SG_CASE(8, 32) TLT_SG_CASE(8, 64) TLT_SG_CASE(8, 128)
    case 4 * 1000 + 128:  // moe_matmul.cu's but in the side-timing copy (64: no new instance)
      if (!SIDE_W4G128) return (int)cudaErrorInvalidValue;
      return (int)launch<4, SIDE_W4G128 ? 128 : 64>(xp, wp, sp, bp, gp, op, T, N, Kp, E, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TLT_SG_CASE
}

// The route for T grouped rows: 0 the GEMV walk, 1 the bf16 tile walk.
extern "C" int tlt_grouped_quant_matmul_sg_route(int T) { return T >= SG_B16_MIN_T ? 1 : 0; }
