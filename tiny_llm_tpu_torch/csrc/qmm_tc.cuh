// K1's two tensor-core routes above one row (quant_matmul.cu): the W4 g128
// weights (ops/quantize.py layout: int32 [N, Kp / 8], code j of a word in
// bits [4j, 4j + 4); bf16 scales and biases [N, Kp / 128]) against bf16 x
// [M, Kp]. Each reads every weight word once for all the rows it holds.
//
// Nibbles to bf16 without a float conversion (the TPU kernel's magic,
// quant_matmul.py:216-231): ((w >> 4j) & 0x000F000F) | 0x43004300 is the
// bf16 pair 128 + q of codes j and j + 4 of the word, exactly.
//
//  * b16:: (decode and serving rows), the W4A8 tile's schedule
//    (qmm_tile.cuh a8::) with bf16 products: a block holds 128 columns and
//    BM = 16 MT rows (MT = 1, 2); the weight words (by TMA) and x rows (cp.async) of
//    one 128-code group a stage move through a ring, so the block reads
//    each weight once for its rows; the scales and biases are staged 16
//    groups at a time. The products run as mma.sync m16n8k16 bf16 (HMMA, f32 sums) on
//    the magic pairs, x taken in the same k order (codes j and j + 4 of a
//    word: its x pairs are byte-permuted from the row as they are read).
//    With the magic's 128 in the products, each group folds in f32 as the
//    TPU's decode schedule does: acc += d' s + xs (b - 128 s), d' = x .
//    (128 + q), xs the group's x sum; the block sums each stage's x rows
//    (one barrier later, so a group's fold waits one stage). Where the
//    column blocks do not fill the SMs, a thread-block cluster splits each
//    one's k-range and the partial tiles are added through distributed
//    shared memory. The same arithmetic as the plain version up to f32
//    summation order.
//  * staged:: (prefill rows), the staged schedule of the TPU kernel
//    (quant_matmul.py:232-257) on the dequantized weight: a block of two
//    warpgroups holds a 128 x 128 output tile; each group's weight words
//    and x rows arrive through a TMA ring, every thread converts its share
//    of the words into bf16(q s + b) in a shared B tile (the magic pair
//    128 + q to f32, minus 128, one f32 FMA with the scale and the bias,
//    rounded to bf16 once: the dequantized weight of ops/quantize.py
//    exactly), and warpgroup MMAs (wgmma, both operands in shared memory,
//    HGMMA) accumulate x . bf16(q s + b) in f32 over the whole K. The
//    conversion of group g + 1 runs while group g's MMAs do. The epilogue
//    adds the residual in f32 and rounds once. Where the output tiles do
//    not fill the SMs (down and o: 20 column blocks a 128-row tile), a
//    cluster splits each tile's k-range as the bf16 tile's does.
//
// Bound on the H100: the weight bytes (0.53 B a weight) at decode rows;
// at M = 1024 the bf16 tensor-core rate (2 M N K operations).
//
// Both bodies take the width as template parameters, BITS in {2, 4, 8} and
// GSZ in {32, 64, 128} (the any-width matmul, quant_matmul_sg.cu), and at
// the defaults, K1's W4 g128, are the code above (the `if constexpr`
// branches of the other widths fold away). A stage is still 128 codes of
// k: 16 BITS bytes of each weight row, brought by TMA in the swizzle of
// that span (32, 64 or 128 bytes; K1's b16 tile none), and 128 / GSZ
// groups, each with its own scale, bias and x sum.
//  * b16:: at the other widths: each mma.sync step takes, in every thread
//    of a quad, one word of the same group (words 4 w + tig; at W2, where
//    a word holds 16 codes, two threads share a word, codes 4 (tig & 1) ..
//    of it), so a step's 16 k never straddle two groups; its x pairs are
//    read in the step's k order. Each group's d' s is added as the group
//    ends; the bias term xs (b - c s) one stage later, as K1's fold. W2
//    pairs codes j and j + 8 through the mask 0x00030003. W8 codes reach
//    255, past what 128 + q holds in bf16, so each code goes in as its two
//    nibbles: (128 + lo) and (2048 + 16 hi) = 0x4500 | hi, both exact, on
//    the same x: d' = x . (2176 + q), c = 2176 (128 at W2 and W4).
//  * staged:: at the other widths: each thread converts 64 codes of its
//    column a stage with its group's scale and bias (W2 as W4, mask
//    0x00030003; W8 in f32, (2^23 + q) s - 2^23 s in one FMA, which is q s
//    exactly, then + b), each rounded to bf16 once.
#pragma once

#include <cuda.h>  // CUtensorMap (types only: the encoder is fetched at run time)

#include <algorithm>
#include <map>
#include <tuple>

#include <cooperative_groups.h>

#include "flash_mma.cuh"
#include "mma_sync.cuh"

namespace qmm {

// Tensor-memory-accelerator (TMA) copies: one thread asks for a whole 2D
// box of a tensor map; its bytes complete on an mbarrier in shared memory.
// The weight stream moves this way (one request a stage, where cp.async
// needs one a 16 bytes).
namespace tma {

__device__ __forceinline__ void init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Invalidate a quiescent mbarrier, so that its memory may be initialized
// again (a walk of several tiles a block).
__device__ __forceinline__ void inval(uint32_t bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// The mbarriers' inits, visible to the async proxy (TMA) and the block.
__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// Box (c0, c1) of `map` (c0 the inner coordinate, in elements) to dst.
__device__ __forceinline__ void load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                        int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                            const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                            const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A 2D tensor map of `rows` rows of `cols` elements of `type` (row pitch
// `pitch` bytes) in boxes of box_cols x box_rows; rows and columns past the
// tensor read as zeros. The encoder, cuTensorMapEncodeTiled, is fetched
// once, by name.
inline cudaError_t encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                             uint64_t cols, uint64_t rows, uint64_t pitch, uint32_t box_cols,
                             uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  static const Encode fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<Encode>(p);
  }();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows}, strides[1] = {pitch};
  const cuuint32_t box[2] = {box_cols, box_rows}, estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// The packed weights w [N, Kp BITS / 32] int32 in boxes of one 128-code
// stage (4 BITS words) by `rows` rows.
inline cudaError_t weight_map(CUtensorMap* map, const uint32_t* w, int N, int Kp, int rows,
                              CUtensorMapSwizzle swizzle, int bits = 4) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_INT32, w, (uint64_t)Kp * bits / 32, N,
                   (uint64_t)Kp * bits / 8, 4 * bits, rows, swizzle);
}

// The swizzle of a row of 16 BITS bytes (a stage of one weight row).
inline CUtensorMapSwizzle row_swizzle(int bits) {
  return bits == 2 ? CU_TENSOR_MAP_SWIZZLE_32B
                   : bits == 4 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
}

// weight_map in boxes of 128 rows, encoded once per weight (the weights
// never move) and kept.
inline cudaError_t cached_weight_map(CUtensorMap* map, const uint32_t* w, int N, int Kp,
                                     CUtensorMapSwizzle swizzle, int bits = 4) {
  static std::map<std::tuple<const void*, int, int, int, int>, CUtensorMap> maps;
  const auto key = std::make_tuple(static_cast<const void*>(w), N, Kp, (int)swizzle, bits);
  const auto it = maps.find(key);
  if (it != maps.end()) {
    *map = it->second;
    return cudaSuccess;
  }
  const cudaError_t e = weight_map(map, w, N, Kp, 128, swizzle, bits);
  if (e == cudaSuccess) maps.emplace(key, *map);
  return e;
}

}  // namespace tma

// The blocks of a cluster that split each of `blocks` output tiles'
// k-range: up to 8, each one 128-code stage at least, while the grid stays
// within one block an SM (a second block on an SM would stream its bytes
// after the first's).
inline int cluster_ranks(int Kp, int blocks, int sms) {
  return std::max(1, std::min({8, Kp / 128, sms / blocks}));
}

// Launch `kernel` on `grid` in clusters of `ranks` blocks along x,
// `threads` threads and `smem` bytes of dynamic shared memory a block (the
// caller allows the kernel that much first).
template <class... Params, class... Args>
cudaError_t launch_clustered(void (*kernel)(Params...), dim3 grid, int threads, int smem,
                             int ranks, cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

__device__ __forceinline__ uint32_t magic_pair(uint32_t w, int j) {
  return ((w >> (4 * j)) & 0x000F000Fu) | 0x43004300u;
}

// W2: the bf16 pair 128 + q of codes j and j + 8 of the word.
__device__ __forceinline__ uint32_t magic_pair2(uint32_t w, int j) {
  return ((w >> (2 * j)) & 0x00030003u) | 0x43004300u;
}

// Byte offset of 16-byte chunk c of row r in rows of W_ROW bytes in TMA's
// swizzle of that span (32, 64 or 128 bytes): chunk c at c ^ (r's bits
// 7-9 of the address), so eight consecutive rows' chunks hit distinct
// banks. The rows start aligned to 8 W_ROW.
template <int W_ROW>
__device__ __forceinline__ int swz_row(int r, int c) {
  constexpr int SHIFT = W_ROW == 32 ? 2 : W_ROW == 64 ? 1 : 0, MASK = W_ROW / 16 - 1;
  return r * W_ROW + ((c ^ ((r >> SHIFT) & MASK)) << 4);
}

constexpr int PLD = 128 + 8;  // f32 row of a 128-column partial tile

// A ROWS x 128 output tile at rows m0.., columns n0.. from the f32 partial
// tiles `part` [ROWS][PLD] (shared memory) of the `nrank` blocks of the
// cluster, added in rank order: out[m, n] = bf16(sum (+ res[m, n])) for the
// rows below M and columns below N. This block stores the 4-column chunks
// rank, rank + nrank, ..., reading each chunk of every rank (distributed
// shared memory) in one round. Every thread of every block of the cluster
// calls it (it syncs the cluster, or the block when nrank is 1).
template <int ROWS, int THREADS>
__device__ __forceinline__ void cluster_store(const float* part,
                                              const __nv_bfloat16* __restrict__ res,
                                              __nv_bfloat16* __restrict__ out, int m0, int M,
                                              int n0, int N, int rank, int nrank) {
  namespace cg = cooperative_groups;
  constexpr int BN = 128, CHUNKS = ROWS * BN / 4, MAX_RANKS = 8;
  const int tid = threadIdx.x;
  cg::cluster_group cluster = cg::this_cluster();
  if (nrank == 1)
    __syncthreads();
  else
    cluster.sync();  // the partial tiles are published
  const int nown = (CHUNKS - rank + nrank - 1) / nrank;
  for (int i = tid; i < nown; i += THREADS) {
    const int c = rank + i * nrank;
    const int r = c / (BN / 4), n = n0 + c % (BN / 4) * 4, m = m0 + r;
    if (m >= M || n >= N) continue;
    const bool whole = n + 3 < N && N % 4 == 0;  // an aligned 4-column chunk
    float rv[4] = {0.f, 0.f, 0.f, 0.f};
    if (res != nullptr) {
      const __nv_bfloat16* rp = res + (size_t)m * N + n;
      if (whole) {
        const uint2 w2 = *reinterpret_cast<const uint2*>(rp);
        rv[0] = lo_bf16(w2.x), rv[1] = hi_bf16(w2.x), rv[2] = lo_bf16(w2.y), rv[3] = hi_bf16(w2.y);
      } else {
        for (int e = 0; e < 4 && n + e < N; ++e) rv[e] = bf2f(rp[e]);
      }
    }
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < MAX_RANKS; ++q) {
      if (q < nrank) {
        const float* pq = nrank == 1 ? part : cluster.map_shared_rank(part, q);
        const float4 v = *reinterpret_cast<const float4*>(pq + r * PLD + c % (BN / 4) * 4);
        sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
      }
    }
    const float y[4] = {sum.x + rv[0], sum.y + rv[1], sum.z + rv[2], sum.w + rv[3]};
    __nv_bfloat16* op = out + (size_t)m * N + n;
    if (whole) {
      *reinterpret_cast<uint2*>(op) = make_uint2(
          (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(y[0])) |
              ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(y[1])) << 16),
          (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(y[2])) |
              ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(y[3])) << 16));
    } else {
      for (int e = 0; e < 4 && n + e < N; ++e) op[e] = __float2bfloat16_rn(y[e]);
    }
  }
  // No block leaves while others read its partial tile.
  if (nrank == 1) {
    __syncthreads();
  } else {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\nbarrier.cluster.wait.aligned;\n" :::
                     "memory");
  }
}

namespace b16 {

constexpr int BN = 128, THREADS = 256, GROUP = 128;
constexpr int ALIGN = 128;           // TMA's destination alignment (the smem base is rounded up)
constexpr int XLD = 2 * GROUP + 32;  // x row of a stage, bytes (see x_unit)
constexpr int W_BYTES = BN * 64;     // a stage's weight words: BN rows of 64 bytes
constexpr int SB_GROUPS = 16;        // groups of scales and biases staged at a time

// Where logical 16-byte unit u (0..15) of a stage's x row lives: units
// 8..15 swap neighbours, so the four lanes of a quad reading units 4 tig + i
// (and the next row, XLD / 16 = 18 units on) hit distinct banks.
__device__ __forceinline__ int x_unit(int u) { return u ^ ((u >> 3) & 1); }

// A stage at a width. K1's (W4 g128): the constants above, weight rows of
// 64 bytes unswizzled, x units placed by x_unit. The other widths: weight
// rows of 16 BITS bytes in TMA's swizzle of that span (swz_row), stages
// aligned to its period, x units in order in rows of XLD bytes (W4: 320,
// so the two rows of a quarter warp's 64 bytes fall on distinct banks).
template <int BITS, int GSZ>
struct Width {
  static constexpr bool K1 = BITS == 4 && GSZ == GROUP;
  static constexpr int W_ROW = 16 * BITS, W_BYTES = BN * W_ROW;
  static constexpr int XLD = BITS == 4 && !K1 ? 2 * GROUP + 64 : b16::XLD;
  static constexpr int STAGE_ALIGN = K1 ? b16::ALIGN : 8 * W_ROW;
  static constexpr int ALIGN = K1 ? b16::ALIGN : 1024;  // the ring's base
  static constexpr int NGS = GROUP / GSZ;                // groups a stage
  static constexpr float OFFSET = BITS == 8 ? 2176.f : 128.f;  // the conversion's offset
  static __device__ __forceinline__ int x_at(int u) {
    if constexpr (K1) {
      return x_unit(u);
    } else {
      return u;
    }
  }
};

template <int MT, int BITS = 4, int GSZ = GROUP>
struct Shape {
  using Wd = Width<BITS, GSZ>;
  static constexpr int BM = 16 * MT;
  static constexpr int STAGES = BITS == 8 ? 4 : MT == 1 ? 7 : 5;  // two blocks an SM
  static constexpr int STAGE_BYTES =
      (Wd::W_BYTES + BM * Wd::XLD + Wd::STAGE_ALIGN - 1) / Wd::STAGE_ALIGN * Wd::STAGE_ALIGN;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  // The ring, the staged scales and biases, the x sums, a weight mbarrier
  // a stage (at BARS); + slack to align the ring.
  static constexpr int BARS = RING_BYTES + SB_GROUPS * BN * 4 + STAGES * Wd::NGS * BM * 4;
  static constexpr int SMEM_BYTES = BARS + STAGES * 8 + Wd::ALIGN;
  static_assert(STAGE_BYTES % ALIGN == 0, "every stage's weights TMA-aligned");
  static_assert(RING_BYTES >= BM * PLD * 4, "the partial tile reuses the ring");
  static_assert(2 * (SMEM_BYTES + 1024) <= 233472, "two blocks an SM");
};

// The block's shared memory, the ring aligned for TMA.
__device__ __forceinline__ unsigned char* aligned(unsigned char* smem) {
  const uint32_t a = smem_u32(smem);
  return smem + (((a + ALIGN - 1) & ~(uint32_t)(ALIGN - 1)) - a);
}

// The same to A bytes (Width::ALIGN).
template <int A>
__device__ __forceinline__ unsigned char* aligned_to(unsigned char* smem) {
  const uint32_t a = smem_u32(smem);
  return smem + (((a + A - 1) & ~(uint32_t)(A - 1)) - a);
}

// Rows [m0, m0 + BM) of out (those below M), columns [n0, n0 + BN) (below
// N), stages [g0, g1) of the k-range (128 codes each: K1's groups): the
// block's f32 sums in acc [MT][2][4] (m16 tile, n8 tile of the warp's 16
// columns, fragment element). wmap: tma::weight_map of the weights in boxes
// of BN rows (other widths than K1's: in tma::row_swizzle(BITS)); column n0
// is its row w_row0 + n0 (the grouped walk: a stack of experts' weights).
// smem: aligned_to<Width::ALIGN>(). Every thread calls it (it syncs).
template <int MT, int BITS = 4, int GSZ = GROUP>
__device__ __forceinline__ void tile_mma(const __nv_bfloat16* __restrict__ x,
                                         const CUtensorMap* wmap,
                                         const __nv_bfloat16* __restrict__ s,
                                         const __nv_bfloat16* __restrict__ b, int m0, int M,
                                         int n0, int N, int Kp, int g0, int g1,
                                         unsigned char* smem, float (&acc)[MT][2][4],
                                         int w_row0 = 0) {
  using S = Shape<MT, BITS, GSZ>;
  using Wd = Width<BITS, GSZ>;
  constexpr int BM = S::BM, STAGES = S::STAGES, NGS = Wd::NGS;
  constexpr int SB_STAGES = SB_GROUPS / NGS;  // stages whose scales and biases are staged at a time
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int G = Kp / GSZ, ng = g1 - g0;
  const uint32_t ring = smem_u32(smem);
  uint32_t* sb_s = reinterpret_cast<uint32_t*>(smem + S::RING_BYTES);  // [SB_GROUPS][BN]: s | b << 16
  float* xs_s = reinterpret_cast<float*>(smem + S::RING_BYTES + SB_GROUPS * BN * 4);  // [STAGES][NGS][BM]
  const uint32_t bars = smem_u32(xs_s + STAGES * NGS * BM);  // [STAGES] mbarriers: slot's weights landed
  if (tid == 0) {
    for (int k = 0; k < STAGES; ++k) tma::init(bars + 8 * k, 1);
    tma::fence_init();
  }
  __syncthreads();

  auto load = [&](int i) {  // stage g0 + i's weight words and x rows into slot i % STAGES
    const uint32_t st = ring + (i % STAGES) * S::STAGE_BYTES;
    if (tid == 0) {
      const uint32_t bar = bars + 8 * (i % STAGES);
      tma::expect_tx(bar, Wd::W_BYTES);
      tma::load_2d(st, wmap, bar, (g0 + i) * (4 * BITS), w_row0 + n0);
    }
    for (int c = tid; c < BM * 16; c += THREADS) {
      const int r = c >> 4, u = c & 15;
      const bool ok = m0 + r < M;
      cp_async16(st + Wd::W_BYTES + r * Wd::XLD + Wd::x_at(u) * 16,
                 ok ? x + (size_t)(m0 + r) * Kp + (size_t)(g0 + i) * GROUP + u * 8 : x,
                 ok ? 16 : 0);
    }
  };
  constexpr int SB_PER = SB_GROUPS * BN / THREADS;
  uint32_t sbv[SB_PER];
  auto load_sb = [&](int gl) {  // groups [gl, gl + SB_GROUPS) of s and b, to registers
#pragma unroll
    for (int k = 0; k < SB_PER; ++k) {
      const int e = tid + k * THREADS, c = e / SB_GROUPS, j = e % SB_GROUPS;
      sbv[k] = 0;
      if (n0 + c < N && gl + j < ng * NGS) {
        const size_t o = (size_t)(n0 + c) * G + g0 * NGS + gl + j;
        sbv[k] = (uint32_t)__bfloat16_as_ushort(s[o]) | ((uint32_t)__bfloat16_as_ushort(b[o]) << 16);
      }
    }
  };
  auto store_sb = [&] {
#pragma unroll
    for (int k = 0; k < SB_PER; ++k) {
      const int e = tid + k * THREADS;
      sb_s[e % SB_GROUPS * BN + e / SB_GROUPS] = sbv[k];
    }
  };
  // The x sums of stage i's rows: TPR threads a row, VPT values each (a
  // group's: TPG threads).
  auto row_sums = [&](int i) {
    constexpr int TPR = THREADS / BM, VPT = GROUP / TPR;
    const int r = tid / TPR, p = tid % TPR;
    const unsigned char* xr = smem + (i % STAGES) * S::STAGE_BYTES + Wd::W_BYTES + r * Wd::XLD;
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < VPT / 8; ++k) {
      const uint4 v = *reinterpret_cast<const uint4*>(xr + Wd::x_at(p * (VPT / 8) + k) * 16);
      sum += (lo_bf16(v.x) + hi_bf16(v.x)) + (lo_bf16(v.y) + hi_bf16(v.y)) +
             (lo_bf16(v.z) + hi_bf16(v.z)) + (lo_bf16(v.w) + hi_bf16(v.w));
    }
    if constexpr (NGS == 1) {
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (p == 0) xs_s[(i % STAGES) * BM + r] = sum;
    } else {
      constexpr int TPG = GSZ / VPT;
#pragma unroll
      for (int o = 1; o < TPG; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (p % TPG == 0) xs_s[((i % STAGES) * NGS + p / TPG) * BM + r] = sum;
    }
  };
  float d[MT][2][4];  // K1: the last group's d' = x . (128 + q), folded one stage later
  auto fold = [&](int i) {
    if constexpr (Wd::K1) {  // group i: acc += d' s + xs (b - 128 s)
      const float* xs = xs_s + (i % STAGES) * BM;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint2 sb = *reinterpret_cast<const uint2*>(sb_s + i % SB_GROUPS * BN + warp * 16 +
                                                         j * 8 + tig * 2);
        const float sc[2] = {lo_bf16(sb.x), lo_bf16(sb.y)};
        const float cb[2] = {hi_bf16(sb.x) - 128.f * sc[0], hi_bf16(sb.y) - 128.f * sc[1]};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float x0 = xs[mt * 16 + g], x1 = xs[mt * 16 + g + 8];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[mt][j][c] += d[mt][j][c] * sc[c & 1] + (c < 2 ? x0 : x1) * cb[c & 1];
        }
      }
    } else {  // stage i's groups: acc += xs (b - OFFSET s) (their d' s went in as each ended)
#pragma unroll
      for (int gi = 0; gi < NGS; ++gi) {
        const float* xs = xs_s + ((i % STAGES) * NGS + gi) * BM;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint2 sb = *reinterpret_cast<const uint2*>(
              sb_s + (i * NGS + gi) % SB_GROUPS * BN + warp * 16 + j * 8 + tig * 2);
          const float cb[2] = {hi_bf16(sb.x) - Wd::OFFSET * lo_bf16(sb.x),
                               hi_bf16(sb.y) - Wd::OFFSET * lo_bf16(sb.y)};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const float x0 = xs[mt * 16 + g], x1 = xs[mt * 16 + g + 8];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[mt][j][c] += (c < 2 ? x0 : x1) * cb[c & 1];
          }
        }
      }
    }
  };
  // Other widths: acc += d' s of group gl of the k-range (this stage's).
  auto scale_fold = [&](int gl) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint2 sb = *reinterpret_cast<const uint2*>(sb_s + gl % SB_GROUPS * BN + warp * 16 +
                                                       j * 8 + tig * 2);
      const float sc[2] = {lo_bf16(sb.x), lo_bf16(sb.y)};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][j][c] += d[mt][j][c] * sc[c & 1];
    }
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ng) load(i);
    cp_async_commit();
  }
  load_sb(0);
  store_sb();
  for (int i = 0; i < ng; ++i) {
    const bool reload = i % SB_STAGES == 0 && i > 0;
    if (reload) load_sb(i * NGS);
    cp_async_wait<STAGES - 2>();
    tma::wait(bars + 8 * (i % STAGES), (i / STAGES) & 1);
    __syncthreads();  // slot i landed; slot i - 1 is free; xs of stage i - 1 and sb written
    if (i + STAGES - 1 < ng) {
      if (tid == 0) fmma::fence_proxy_async();  // the slot's reads before its TMA refill
      load(i + STAGES - 1);
    }
    cp_async_commit();
    row_sums(i);
    if (i > 0) fold(i - 1);
    if (reload) {
      __syncthreads();  // every warp folded stage i - 1 with the last chunk
      store_sb();
      if constexpr (!Wd::K1) __syncthreads();  // the chunk written before stage i's groups fold
    }

    const unsigned char* st = smem + (i % STAGES) * S::STAGE_BYTES;
    if constexpr (Wd::K1) {
      // d' of group i: the warp's 16 columns (two n8 tiles), the thread's
      // words 4 tig .. 4 tig + 3 of each; x row pairs in the same k order.
      uint32_t wv[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(st + (warp * 16 + j * 8 + g) * 64 + tig * 16);
        wv[j][0] = v.x;
        wv[j][1] = v.y;
        wv[j][2] = v.z;
        wv[j][3] = v.w;
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) d[mt][j][c] = 0.f;
#pragma unroll
      for (int wi = 0; wi < 4; ++wi) {
        const int u = x_unit(4 * tig + wi);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const unsigned char* xr = st + W_BYTES + (mt * 16 + g) * XLD + u * 16;
          const uint4 r0 = *reinterpret_cast<const uint4*>(xr);            // row g
          const uint4 r1 = *reinterpret_cast<const uint4*>(xr + 8 * XLD);  // row g + 8
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // Codes 2h and 2h + 4 of the word, then 2h + 1 and 2h + 5.
            const uint32_t lo0 = h ? r0.y : r0.x, hi0 = h ? r0.w : r0.z;
            const uint32_t lo1 = h ? r1.y : r1.x, hi1 = h ? r1.w : r1.z;
            const uint32_t a[4] = {__byte_perm(lo0, hi0, 0x5410), __byte_perm(lo1, hi1, 0x5410),
                                   __byte_perm(lo0, hi0, 0x7632), __byte_perm(lo1, hi1, 0x7632)};
#pragma unroll
            for (int j = 0; j < 2; ++j)
              mma16816(d[mt][j], a, magic_pair(wv[j][wi], 2 * h), magic_pair(wv[j][wi], 2 * h + 1));
          }
        }
      }
    } else {
      // Steps of 32 codes (W8: 16), each thread one word of the step's
      // group: words 4 w + tig of each row (W2: word 2 w + tig / 2, codes
      // 4 (tig & 1) .. of it); SPG steps a group.
      constexpr int STEPS = BITS == 8 ? 8 : 4, SPG = GSZ / (GROUP / STEPS);
      const unsigned char* xst = st + Wd::W_BYTES;
#pragma unroll
      for (int w = 0; w < STEPS; ++w) {
        if (w % SPG == 0) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c) d[mt][j][c] = 0.f;
        }
        const int wd = BITS == 2 ? 2 * w + (tig >> 1) : 4 * w + tig;
        uint32_t wv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int rr = warp * 16 + j * 8 + g;
          wv[j] = *reinterpret_cast<const uint32_t*>(st + swz_row<Wd::W_ROW>(rr, wd >> 2) +
                                                     (wd & 3) * 4);
          if constexpr (BITS == 2) wv[j] >>= 8 * (tig & 1);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const unsigned char* xr = xst + (mt * 16 + g) * Wd::XLD;  // row g; row g + 8 below
          if constexpr (BITS == 4) {  // x unit wd: the word's 8 codes
            const uint4 r0 = *reinterpret_cast<const uint4*>(xr + wd * 16);
            const uint4 r1 = *reinterpret_cast<const uint4*>(xr + 8 * Wd::XLD + wd * 16);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t lo0 = h ? r0.y : r0.x, hi0 = h ? r0.w : r0.z;
              const uint32_t lo1 = h ? r1.y : r1.x, hi1 = h ? r1.w : r1.z;
              const uint32_t a[4] = {__byte_perm(lo0, hi0, 0x5410), __byte_perm(lo1, hi1, 0x5410),
                                     __byte_perm(lo0, hi0, 0x7632), __byte_perm(lo1, hi1, 0x7632)};
#pragma unroll
              for (int j = 0; j < 2; ++j)
                mma16816(d[mt][j], a, magic_pair(wv[j], 2 * h), magic_pair(wv[j], 2 * h + 1));
            }
          } else if constexpr (BITS == 2) {
            // Codes 2h and 2h + 8, 2h + 1 and 2h + 9 of the word, h = 2
            // (tig & 1) + r: x pairs h of its two units (units 2 wd, 2 wd + 1).
            const int o = wd * 32 + 8 * (tig & 1);
            const uint2 l0 = *reinterpret_cast<const uint2*>(xr + o);
            const uint2 h0 = *reinterpret_cast<const uint2*>(xr + o + 16);
            const uint2 l1 = *reinterpret_cast<const uint2*>(xr + 8 * Wd::XLD + o);
            const uint2 h1 = *reinterpret_cast<const uint2*>(xr + 8 * Wd::XLD + o + 16);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const uint32_t lo0 = r ? l0.y : l0.x, hi0 = r ? h0.y : h0.x;
              const uint32_t lo1 = r ? l1.y : l1.x, hi1 = r ? h1.y : h1.x;
              const uint32_t a[4] = {__byte_perm(lo0, hi0, 0x5410), __byte_perm(lo1, hi1, 0x5410),
                                     __byte_perm(lo0, hi0, 0x7632), __byte_perm(lo1, hi1, 0x7632)};
#pragma unroll
              for (int j = 0; j < 2; ++j)
                mma16816(d[mt][j], a, magic_pair2(wv[j], 2 * r), magic_pair2(wv[j], 2 * r + 1));
            }
          } else {
            // W8: codes h and h + 2 of the word, low nibbles (128 + lo)
            // and high nibbles (2048 + 16 hi) on the same x pair.
            const uint2 p0 = *reinterpret_cast<const uint2*>(xr + wd * 8);
            const uint2 p1 = *reinterpret_cast<const uint2*>(xr + 8 * Wd::XLD + wd * 8);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t a0 = __byte_perm(p0.x, p0.y, h ? 0x7632 : 0x5410);
              const uint32_t a1 = __byte_perm(p1.x, p1.y, h ? 0x7632 : 0x5410);
              const uint32_t a[4] = {a0, a1, a0, a1};
#pragma unroll
              for (int j = 0; j < 2; ++j)
                mma16816(d[mt][j], a, ((wv[j] >> (8 * h)) & 0x000F000Fu) | 0x43004300u,
                         ((wv[j] >> (8 * h + 4)) & 0x000F000Fu) | 0x45004500u);
            }
          }
        }
        if (w % SPG == SPG - 1) scale_fold(i * NGS + w / SPG);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // xs of the last stage written; the ring is free for the partial tile
  if (ng > 0) fold(ng - 1);
}

// The output tile of tile_mma's sums over the `nrank` blocks of the
// cluster (each one k-range; nrank 1: the block alone): the fragments into
// the ring as an f32 partial tile, then cluster_store. Every thread of
// every block of the cluster calls it.
template <int MT>
__device__ __forceinline__ void tile_store(const float (&acc)[MT][2][4],
                                           const __nv_bfloat16* __restrict__ res,
                                           __nv_bfloat16* __restrict__ out, int m0, int M, int n0,
                                           int N, int rank, int nrank, unsigned char* smem) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(part + (mt * 16 + g + h * 8) * PLD + warp * 16 + j * 8 +
                                   tig * 2) = make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
  cluster_store<16 * MT, THREADS>(part, res, out, m0, M, n0, N, rank, nrank);
}

}  // namespace b16

namespace staged {

constexpr int BM = 128, BN = 128, THREADS = 256, GROUP = 128, STAGES = 3;
constexpr int X_BYTES = BM * GROUP * 2;  // a stage's x rows: two 128-byte-swizzled 64-k blocks
constexpr int W_BYTES = BN * 64;         // a stage's weight words: BN rows of 64 bytes (w_chunk)
constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
constexpr int B_BYTES = BN * GROUP * 2;  // the converted bf16(q s + b) tile
// The ring, two B tiles, a mbarrier a stage; + slack to align the tiles to
// 1024 bytes.
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * B_BYTES + STAGES * 8 + 1024;
static_assert(STAGES * STAGE_BYTES >= BM * PLD * 4, "the partial tile reuses the ring");
static_assert(SMEM_BYTES <= 232448, "a block's shared memory");

// D (64 x 128, f32) += A B, both operands in shared memory by descriptor,
// both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Where 16-byte chunk c (0..3) of weight row r lives in a stage: rows
// of 64 bytes, chunk c at c ^ ((r >> 1) & 3) (TMA's 64-byte swizzle), so
// the eight rows a quarter warp converts hit distinct banks.
__device__ __forceinline__ int w_chunk(int r, int c) { return r * 64 + ((c ^ ((r >> 1) & 3)) << 4); }

// A stage at a width (K1's, W4 g128: the constants above): weight rows of
// 16 BITS bytes in the swizzle of that span (swz_row), NGS groups a stage.
template <int BITS, int GSZ>
struct Width {
  static constexpr int W_BYTES = BN * 16 * BITS, STAGE_BYTES = X_BYTES + W_BYTES;
  static constexpr int NGS = GROUP / GSZ;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * B_BYTES + STAGES * 8 + 1024;
  static_assert(SMEM_BYTES <= 232448, "a block's shared memory");
  static_assert(STAGE_BYTES % 1024 == 0, "every stage's tiles at the swizzle's period");
};

// The 128 x 128 output tile at rows m0.., columns n0.. (rows at or past M
// and columns at or past N load as zeros and are not written), over stages
// [g0, g1) of K (128 codes each: K1's groups): block `rank` of a cluster of
// `nrank` (1: alone) that splits the tile's k-range, the partial tiles added
// by cluster_store. xmap: x [M, Kp] bf16 in boxes of 64 k by BM rows,
// 128-byte swizzled; wmap: tma::weight_map in boxes of BN rows, in
// tma::row_swizzle(BITS) (64-byte at K1's width). THREADS threads,
// Width::SMEM_BYTES of dynamic shared memory.
template <int BITS = 4, int GSZ = GROUP>
__device__ __forceinline__ void tile(const CUtensorMap* xmap, const CUtensorMap* wmap,
                                     const __nv_bfloat16* __restrict__ s,
                                     const __nv_bfloat16* __restrict__ b,
                                     const __nv_bfloat16* __restrict__ res,
                                     __nv_bfloat16* __restrict__ out, int m0, int n0, int M,
                                     int N, int Kp, int g0, int g1, int rank, int nrank,
                                     unsigned char* smem_raw) {
  using fmma::swz;
  using Wd = Width<BITS, GSZ>;
  constexpr bool K1 = BITS == 4 && GSZ == GROUP;
  constexpr int NGS = Wd::NGS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int g = lane >> 2, tig = lane & 3;
  const int G = Kp / GSZ, ng = g1 - g0;
  const uint32_t sraw = smem_u32(smem_raw), sbase = (sraw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (sbase - sraw);
  const uint32_t bbase = sbase + STAGES * Wd::STAGE_BYTES;  // two B tiles
  const uint32_t bars = bbase + 2 * B_BYTES;  // [STAGES] mbarriers: the slot landed
  if (tid == 0) {
    for (int k = 0; k < STAGES; ++k) tma::init(bars + 8 * k, 1);
    tma::fence_init();
  }
  __syncthreads();

  auto load = [&](int i) {  // thread 0: stage i's x rows and weight words into slot i % STAGES
    const uint32_t st = sbase + (i % STAGES) * Wd::STAGE_BYTES, bar = bars + 8 * (i % STAGES);
    tma::expect_tx(bar, Wd::STAGE_BYTES);
    tma::load_2d(st, xmap, bar, (g0 + i) * GROUP, m0);
    tma::load_2d(st + BM * 128, xmap, bar, (g0 + i) * GROUP + 64, m0);
    tma::load_2d(st + X_BYTES, wmap, bar, (g0 + i) * (4 * BITS), n0);
  };
  auto landed = [&](int i) { tma::wait(bars + 8 * (i % STAGES), (i / STAGES) & 1); };
  // This thread converts column cn's codes 64 half .. 64 half + 63 of each
  // stage (K1: words 8 half .. 8 half + 7).
  const int cn = tid & (BN - 1), half = tid >> 7;
  const bool col_ok = n0 + cn < N;
  const size_t sb_row = (size_t)(n0 + cn) * G;
  constexpr int NGT = GSZ < 64 ? 64 / GSZ : 1;  // groups of a thread's 64 codes
  // The next stage's scales and biases of this thread's groups, raw bf16
  // (K1: one group).
  uint32_t s_grp[NGT] = {}, b_grp[NGT] = {};
  auto fetch_sb = [&](int i) {
#pragma unroll
    for (int e = 0; e < NGT; ++e) {
      const size_t at = sb_row + (size_t)(g0 + i) * NGS + (K1 ? 0 : half * 64 / GSZ + e);
      s_grp[e] = col_ok && i < ng ? __bfloat16_as_ushort(s[at]) : 0;
      b_grp[e] = col_ok && i < ng ? __bfloat16_as_ushort(b[at]) : 0;
    }
  };
  // The bf16 pair (128 + q0, 128 + q1) (the magic) to the pair of
  // bf16(q s + b): q exactly in f32, then one FMA, rounded once.
  auto dequant_pair = [](uint32_t pr, float sf, float bf) {
    const float q0 = __uint_as_float(pr << 16) - 128.f, q1 = __uint_as_float(pr & 0xFFFF0000u) - 128.f;
    return fmma::pack_bf16(__fmaf_rn(q0, sf, bf), __fmaf_rn(q1, sf, bf));
  };
  auto convert = [&](int i) {  // stage i: bf16(q s + b) into B tile i % 2
    if constexpr (K1) {
      const unsigned char* wr = smem + (i % STAGES) * STAGE_BYTES + X_BYTES;
      const uint4 v0 = *reinterpret_cast<const uint4*>(wr + w_chunk(cn, 2 * half));
      const uint4 v1 = *reinterpret_cast<const uint4*>(wr + w_chunk(cn, 2 * half + 1));
      const uint32_t words[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
      const float sf = __uint_as_float(s_grp[0] << 16), bf = __uint_as_float(b_grp[0] << 16);
      const uint32_t bt = bbase + (i & 1) * B_BYTES;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t wd = words[k], t = wd >> 4;
        uint32_t o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // Byte e of the word: codes 2e (its low nibble) and 2e + 1 (the
          // low nibble of byte e of t), as the bf16 pair 128 + q.
          const uint32_t pr =
              (__byte_perm(wd, t, e | (e << 4) | ((4 + e) << 8) | ((4 + e) << 12)) & 0x000F000Fu) |
              0x43004300u;
          o[e] = dequant_pair(pr, sf, bf);
        }
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(bt + swz<BN>(cn, half * 8 + k)),
                     "r"(o[0]), "r"(o[1]), "r"(o[2]), "r"(o[3])
                     : "memory");
      }
    } else {
      // The thread's BITS / 2 chunks of the row: BITS words of 32 / BITS
      // codes, 8 chunks of 8 codes out (chunk k in group k * 8 / GSZ of the
      // thread's).
      constexpr int NCH = BITS / 2;
      const unsigned char* wr = smem + (i % STAGES) * Wd::STAGE_BYTES + X_BYTES;
      uint32_t words[4 * NCH];
#pragma unroll
      for (int m = 0; m < NCH; ++m) {
        const uint4 v = *reinterpret_cast<const uint4*>(wr + swz_row<16 * BITS>(cn, NCH * half + m));
        words[4 * m] = v.x;
        words[4 * m + 1] = v.y;
        words[4 * m + 2] = v.z;
        words[4 * m + 3] = v.w;
      }
      const uint32_t bt = bbase + (i & 1) * B_BYTES;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int gk = k * 8 / (GSZ < 64 ? GSZ : 64);
        const float sf = __uint_as_float(s_grp[gk] << 16), bf = __uint_as_float(b_grp[gk] << 16);
        uint32_t o[4];
        if constexpr (BITS == 8) {
          // Words 2k and 2k + 1, four codes each: q s = (2^23 + q) s - 2^23 s
          // in one f32 FMA (exact: q s has 16 significant bits), then + b,
          // rounded to bf16 once.
          const float c8 = -8388608.f * sf;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t wd = words[2 * k + (e >> 1)];
            const int b0 = 2 * (e & 1);
            const float f0 = __fmaf_rn(__uint_as_float(__byte_perm(wd, 0x4B000000u, b0 | 0x7440)), sf, c8);
            const float f1 =
                __fmaf_rn(__uint_as_float(__byte_perm(wd, 0x4B000000u, (b0 + 1) | 0x7440)), sf, c8);
            o[e] = fmma::pack_bf16(f0 + bf, f1 + bf);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            uint32_t pr;
            if constexpr (BITS == 4) {  // byte e of word k: codes 2e, 2e + 1
              const uint32_t wd = words[k];
              pr = (__byte_perm(wd, wd >> 4, e | (e << 4) | ((4 + e) << 8) | ((4 + e) << 12)) &
                    0x000F000Fu) | 0x43004300u;
            } else {  // W2: codes 8 (k & 1) + 2e, + 1 of word k / 2: byte 2 (k & 1) + e / 2
              const uint32_t wd = words[k >> 1] >> (4 * (e & 1));
              const int by = 2 * (k & 1) + (e >> 1);
              pr = (__byte_perm(wd, wd >> 2, by | (by << 4) | ((4 + by) << 8) | ((4 + by) << 12)) &
                    0x00030003u) | 0x43004300u;
            }
            o[e] = dequant_pair(pr, sf, bf);
          }
        }
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(bt + swz<BN>(cn, half * 8 + k)),
                     "r"(o[0]), "r"(o[1]), "r"(o[2]), "r"(o[3])
                     : "memory");
      }
    }
  };

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  // Prologue: the first stages in flight, stage 0 converted.
  if (tid == 0)
    for (int i = 0; i < STAGES - 1 && i < ng; ++i) load(i);
  fetch_sb(0);
  landed(0);
  convert(0);
  fetch_sb(1);
  fmma::fence_proxy_async();
  __syncthreads();  // B tile 0 written

  const uint32_t xw = sbase + wg * 64 * 128;  // this warpgroup's 64 x rows
  for (int i = 0; i < ng; ++i) {
    // Stage g0 + i's MMAs: x (64 rows of the warpgroup) . bf16(q s) over 128 k.
    const uint32_t xa = xw + (i % STAGES) * Wd::STAGE_BYTES, ba = bbase + (i & 1) * B_BYTES;
    fmma::fence_regs(acc);
    fmma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GROUP / 16; ++kk)
      wgmma_ss_n128(acc, fmma::sw128_desc(xa + (kk >> 2) * BM * 128 + (kk & 3) * 32, 0, 1024),
                    fmma::sw128_desc(ba + (kk >> 2) * BN * 128 + (kk & 3) * 32, 0, 1024));
    fmma::wgmma_commit();
    if (i + 1 < ng) {
      fmma::wgmma_wait<1>();  // this warpgroup's MMAs of stage i - 1 are done
      __syncthreads();  // both warpgroups are done with stage i - 1: its slot is free
      if (tid == 0 && i + STAGES - 1 < ng) {
        fmma::fence_proxy_async();  // the slot's reads before its TMA refill
        load(i + STAGES - 1);
      }
      landed(i + 1);
      convert(i + 1);
      fetch_sb(i + 2);
      fmma::fence_proxy_async();
      __syncthreads();  // B tile (i + 1) % 2 written
    }
  }
  fmma::wgmma_wait<0>();
  fmma::fence_regs(acc);

  // Epilogue: acc (+ res), rounded once; across a
  // cluster's k-ranges through shared memory (the ring is free).
  if (nrank > 1) {
    float* part = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        *reinterpret_cast<float2*>(part + (warp * 16 + g + 8 * h) * PLD + 8 * j + 2 * tig) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    cluster_store<BM, THREADS>(part, res, out, m0, M, n0, N, rank, nrank);
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + warp * 16 + g + 8 * h;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * tig;
      float y0 = acc[4 * j + 2 * h], y1 = acc[4 * j + 2 * h + 1];
      if (n + 1 < N && N % 2 == 0) {
        if (res != nullptr) {
          const uint32_t rw = *reinterpret_cast<const uint32_t*>(res + (size_t)m * N + n);
          y0 += lo_bf16(rw);
          y1 += hi_bf16(rw);
        }
        *reinterpret_cast<uint32_t*>(out + (size_t)m * N + n) = fmma::pack_bf16(y0, y1);
      } else {
        for (int e = 0; e < 2 && n + e < N; ++e) {
          float y = e ? y1 : y0;
          if (res != nullptr) y += bf2f(res[(size_t)m * N + n + e]);
          out[(size_t)m * N + n + e] = __float2bfloat16_rn(y);
        }
      }
    }
  }
}

}  // namespace staged

}  // namespace qmm
