// The dequant-fused matmul bodies shared by K1 and the any-width kernel
// (quant_matmul.cu, quant_matmul_sg.cu) and by the grouped W4A16 and W4A8
// expert matmuls (moe_matmul.cu). Each runs over one weight matrix (w,
// s, b point at its first row) and over a range of x rows, so the dense
// kernels pass [0, M) and the grouped ones an expert's segment of the
// sorted rows.
//
// Weights (ops/quantize.py layout): packed int32 [N, Kp * BITS / 32],
// 32 / BITS consecutive k codes per word, code j in bits [BITS j,
// BITS (j + 1)); scales/biases bf16 [N, Kp / GSZ]; Kp a multiple of KU.
// x is bf16 [*, Kp]. out[m, n] = bf16( sum_k x[m, k] * (q[n, k] * s[n, g] +
// b[n, g]) (+ res[m, n]) ), f32 accumulation, the residual added in f32
// before the bf16 round.
//
// The width is a pair of template parameters, BITS in {2, 4, 8} and GSZ in
// {32, 64, 128}, defaulting to K1's W4 g128: at the defaults every body
// below is the code K1 and the grouped W4A16 kernel ran before the width
// became a parameter (the `if constexpr` branches fold away).
//
//  * gemv_rows: one warp per output row n; each lane streams 16 bytes (32
//    codes at W4, a quarter of one group) per step, so a warp reads 512
//    contiguous bytes of the row. Per lane and x row it accumulates
//    d = sum x*q and xs = sum x over its codes of one group and folds
//    acc += d*s + xs*b — the TPU decode schedule's scale/bias fold, done
//    in f32. Up to MT x rows share one pass over the weights.
//  * gemv_a8_rows (W4 g128 only): the W4A8 GEMV. The block quantizes its
//    MT x rows to int8 in shared memory first (per-row absmax, the JAX
//    package's arithmetic), then gemv_rows's schedule with integer dots:
//    `w & 0x0F0F0F0F` holds a word's even-k codes as bytes and
//    `(w >> 4) & 0x0F0F0F0F` its odd-k codes, and xq is stored even/odd
//    interleaved to match, so two __dp4a give one word's 8-code dot.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace qmm {

constexpr int GS = 128;  // K1's group size
constexpr int KU = 128;  // the K unit: Kp is a multiple, and one tile stage

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v >> 1); }

// NW 32-bit words (bf16 pairs) of x from p, with the widest loads.
template <int NW>
__device__ __forceinline__ void load_x(const __nv_bfloat16* p, uint32_t (&xw)[NW]) {
  if constexpr (NW == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    xw[0] = v.x;
    xw[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < NW / 4; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
      xw[4 * i] = v.x;
      xw[4 * i + 1] = v.y;
      xw[4 * i + 2] = v.z;
      xw[4 * i + 3] = v.w;
    }
  }
}

// Rows m in [m0, min(m0 + MT, m_end)) of out; warp w of the block takes
// column n = blockIdx.x * warps + w (none past N). 256 threads.
template <int MT, int BITS = 4, int GSZ = GS>
__device__ __forceinline__ void gemv_rows(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out,
    int m0, int m_end, int N, int Kp) {
  constexpr int VPW = 32 / BITS;    // codes per word
  constexpr int CHUNK = 4 * VPW;    // codes per 16-byte load
  constexpr int SUB = CHUNK < GSZ ? CHUNK : GSZ;  // codes of one group in a load
  constexpr int NG = CHUNK / SUB;   // groups a load holds: 1, or 2 at W2 g32
  constexpr int WPG = SUB / VPW;    // words per group part
  constexpr uint32_t MASK = (1u << BITS) - 1;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= N) return;
  const int G = Kp / GSZ;
  const int nchunks = Kp / CHUNK;  // 16-byte chunks
  const uint4* wrow = reinterpret_cast<const uint4*>(w + (size_t)n * (Kp / VPW));
  const __nv_bfloat16* srow = s + (size_t)n * G;
  const __nv_bfloat16* brow = b + (size_t)n * G;

  float acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i] = 0.f;

  for (int c = lane; c < nchunks; c += 32) {
    const uint4 wv = __ldg(wrow + c);
    // The first group of the chunk: c * CHUNK / GSZ, as a shift.
    const int g = NG == 1 ? c >> ilog2(GSZ / CHUNK) : c << ilog2(NG);
    float sc[NG], bi[NG];
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      sc[j] = bf2f(srow[g + j]);
      bi[j] = bf2f(brow[g + j]);
    }
    const uint32_t words[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      if (m0 + mi < m_end) {
        const __nv_bfloat16* xr = x + (size_t)(m0 + mi) * Kp + (size_t)c * CHUNK;
        float d = 0.f, xs = 0.f;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          uint32_t xw[VPW / 2];
          load_x<VPW / 2>(xr + t * VPW, xw);
#pragma unroll
          for (int e = 0; e < VPW / 2; ++e) {
            const float x0 = lo_bf16(xw[e]);
            const float x1 = hi_bf16(xw[e]);
            const float q0 = (float)((words[t] >> (2 * BITS * e)) & MASK);
            const float q1 = (float)((words[t] >> (2 * BITS * e + BITS)) & MASK);
            d += x0 * q0 + x1 * q1;
            xs += x0 + x1;
          }
          if constexpr (NG > 1) {
            if ((t + 1) % WPG == 0) {  // the end of one group's words
              acc[mi] += d * sc[t / WPG] + xs * bi[t / WPG];
              d = 0.f;
              xs = 0.f;
            }
          }
        }
        if constexpr (NG == 1) acc[mi] += d * sc[0] + xs * bi[0];
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    const float v = warp_sum(acc[mi]);
    if (lane == 0 && m0 + mi < m_end) {
      float y = v;
      if (res != nullptr) y += bf2f(res[(size_t)(m0 + mi) * N + n]);
      out[(size_t)(m0 + mi) * N + n] = __float2bfloat16_rn(y);
    }
  }
}

// ---------------------------------------------------------------------------
// W4A8 (W4 g128 weights, int8 activations).
// ---------------------------------------------------------------------------

// Dynamic shared memory the W4A8 GEMV needs for MT rows of Kp: the int8
// rows, then MT f32 scales (sx) and 8 f32 per-warp partial maxima.
__host__ __device__ constexpr size_t a8_smem_bytes(int MT, int Kp) {
  return (size_t)MT * Kp + (size_t)MT * 4 + 8 * 4;
}

__device__ __forceinline__ uint32_t pack_s8x4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xFF) | ((uint32_t)(b & 0xFF) << 8) | ((uint32_t)(c & 0xFF) << 16) |
         ((uint32_t)(d & 0xFF) << 24);
}

// x / sx rounded half to even and clipped to [-127, 127], with an IEEE
// division (not x * (1 / sx)): the JAX package's codes bit for bit.
__device__ __forceinline__ int quant_s8(float v, float sx) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(v, sx)), -127.f), 127.f);
}

// Rows m in [m0, min(m0 + MT, m_end)) of out, the W4A8 way (see the file
// header). 256 threads; every thread of the block must call it (it syncs).
// smem: a8_smem_bytes(MT, Kp) bytes, 16-byte aligned.
template <int MT>
__device__ __forceinline__ void gemv_a8_rows(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out,
    int m0, int m_end, int N, int Kp, unsigned char* smem) {
  uint2* xq = reinterpret_cast<uint2*>(smem);  // [MT][Kp / 8]: even 4 codes, odd 4
  float* sx_s = reinterpret_cast<float*>(smem + (size_t)MT * Kp);
  float* red = sx_s + MT;  // [8] per-warp maxima
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw8 = Kp / 8;  // 8-code words per row (one uint4 of x)

  __syncthreads();  // a previous call's readers are done with smem
  // 1. Per-row absmax -> sx = max|x| / 127 (1 where 0).
  for (int mi = 0; mi < MT; ++mi) {
    if (m0 + mi >= m_end) break;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)(m0 + mi) * Kp);
    float mx = 0.f;
    for (int i = tid; i < nw8; i += blockDim.x) {
      const uint4 v = __ldg(xr + i);
      const uint32_t xw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mx = fmaxf(mx, fmaxf(fabsf(lo_bf16(xw[e])), fabsf(hi_bf16(xw[e]))));
    }
    mx = warp_max(mx);
    if (lane == 0) red[warp] = mx;
    __syncthreads();
    if (tid == 0) {
      float m = red[0];
      for (int i = 1; i < (int)(blockDim.x >> 5); ++i) m = fmaxf(m, red[i]);
      const float sx = __fdiv_rn(m, 127.f);
      sx_s[mi] = sx == 0.f ? 1.f : sx;
    }
    __syncthreads();
  }
  // 2. Quantize, even/odd interleaved per 8-code word.
  for (int mi = 0; mi < MT; ++mi) {
    if (m0 + mi >= m_end) break;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)(m0 + mi) * Kp);
    const float sx = sx_s[mi];
    for (int i = tid; i < nw8; i += blockDim.x) {
      const uint4 v = __ldg(xr + i);
      const uint32_t xw[4] = {v.x, v.y, v.z, v.w};
      int q[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        q[2 * e] = quant_s8(lo_bf16(xw[e]), sx);
        q[2 * e + 1] = quant_s8(hi_bf16(xw[e]), sx);
      }
      xq[(size_t)mi * nw8 + i] =
          make_uint2(pack_s8x4(q[0], q[2], q[4], q[6]), pack_s8x4(q[1], q[3], q[5], q[7]));
    }
  }
  __syncthreads();

  // 3. One warp per output row n; each lane a 16-byte chunk (32 codes, a
  //    quarter of one group) per step, as gemv_rows.
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= N) return;  // no sync follows: a caller's next call syncs first
  const int G = Kp / GS;
  const int nchunks = Kp / 32;
  const uint4* wrow = reinterpret_cast<const uint4*>(w + (size_t)n * (Kp / 8));
  const __nv_bfloat16* srow = s + (size_t)n * G;
  const __nv_bfloat16* brow = b + (size_t)n * G;
  float acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i] = 0.f;
  for (int c = lane; c < nchunks; c += 32) {
    const uint4 wv = __ldg(wrow + c);
    const float sc = bf2f(srow[c >> 2]);
    const float bi = bf2f(brow[c >> 2]);
    const uint32_t words[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      if (m0 + mi < m_end) {
        const uint4* xr = reinterpret_cast<const uint4*>(xq + (size_t)mi * nw8 + c * 4);
        const uint4 xa = xr[0], xb = xr[1];  // words 0, 1 and 2, 3 of the chunk
        const uint32_t xe[4] = {xa.x, xa.z, xb.x, xb.z}, xo[4] = {xa.y, xa.w, xb.y, xb.w};
        int d = 0, qs = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          d = __dp4a((int)(words[t] & 0x0F0F0F0Fu), (int)xe[t], d);
          d = __dp4a((int)((words[t] >> 4) & 0x0F0F0F0Fu), (int)xo[t], d);
          qs = __dp4a(0x01010101, (int)xe[t], qs);
          qs = __dp4a(0x01010101, (int)xo[t], qs);
        }
        acc[mi] += (float)d * sc + (float)qs * bi;
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    const float v = warp_sum(acc[mi]);
    if (lane == 0 && m0 + mi < m_end) {
      float y = v * sx_s[mi];
      if (res != nullptr) y += bf2f(res[(size_t)(m0 + mi) * N + n]);
      out[(size_t)(m0 + mi) * N + n] = __float2bfloat16_rn(y);
    }
  }
}

// ---------------------------------------------------------------------------
// W4A8 on the int8 tensor cores: rows above the decode shapes (dense M > 4,
// grouped T > 32). Two kernels a call, as the JAX package quantizes outside
// its kernel (_qmm_pair_pallas, _gqmm_pair_pallas):
//
//  * quantize_row, a block per x row: sx = max|x| / 127 (1 where 0) and the
//    codes xq = clip(rint(x / sx), ±127), gemv_a8_rows's arithmetic, once
//    for all column blocks; with each 128-code group's code sum qs, so no
//    column block sums codes. It lets the tile kernel launch at once
//    (programmatic dependent launch): the tile's first weight copies and
//    scale loads need nothing quantized.
//  * tile_mma + tile_store, a block per (BN = 128 columns, up to BM = 32
//    rows, a range of groups): the weights and xq of one group a stage
//    through a STAGES-deep cp.async ring, so a block reads each weight once
//    for all its rows; mma.sync m16n8k32 s8 x s8 -> s32 (IMMA) on the codes,
//    four k32 steps a group, then acc += d * s + qs * b in f32, the scales
//    and biases staged in smem 16 groups at a time. Where the column blocks
//    leave SMs idle (the dense down, qkv and o shapes), a thread-block
//    cluster of blocks splits each one's k-range, and the partial tiles are
//    added through distributed shared memory in rank order.
//
// Bound: the weight bytes (0.53 B a weight); what the tile spends beyond
// them is its fixed cost a call (the second launch, the ring's first fill,
// the cluster's wait for its slowest block), the same at M = 5 and 32.
//
// k order: the weight word w of a group (codes k = 8j .. 8j + 7) gives its
// even-k codes as the bytes of `w & 0x0F0F0F0F` and its odd-k codes as
// those of `(w >> 4) & 0x0F0F0F0F`. In k32 step s of a group the thread of
// quad lane t takes word 4t + s of its column: even codes as the B
// fragment's first register, odd as its second. quantize_row stores xq so
// that the A fragment's registers hold the same k: per 32-code unit u of a
// row (words 4(u % 4) .. + 3 of group u / 4), 16 bytes of the four words'
// even codes, then 16 bytes of their odd codes. The s32 dots are exact.
namespace a8 {

constexpr int BM = 32, BN = 128, THREADS = 256, STAGES = 7;
// A stage: BN weight rows of one group (64 bytes each), BM xq rows of it
// (128 bytes, padded by 16 so a quarter warp's 16-byte reads of two rows
// fall in distinct banks) and the rows' code sums.
constexpr int XLD = GS + 16;
constexpr int W_BYTES = BN * 64, X_BYTES = BM * XLD;
constexpr int STAGE_BYTES = W_BYTES + X_BYTES + BM * 4;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int SB_GROUPS = 16;      // groups of scales and biases staged at a time
constexpr int SMEM_BYTES = RING_BYTES + SB_GROUPS * BN * 4 + BM * 4;  // + the rows' sx
constexpr int PLD = BN + 8;        // f32 row of the partial tile
static_assert(RING_BYTES >= BM * PLD * 4, "the partial tile reuses the ring");

// The quantized activations of `rows` rows of Kp, in one workspace: xq
// [rows][Kp] int8 (the layout above), qs [Kp / GS][rows] f32, sx [rows] f32.
struct Quantized {
  uint8_t* xq;
  float* qs;
  float* sx;
};
__host__ __device__ constexpr size_t workspace_bytes(int rows, int Kp) {
  return (size_t)rows * Kp + 4 * (size_t)rows * (Kp / GS + 1);
}
__host__ __device__ inline Quantized carve(void* ws, int rows, int Kp) {
  uint8_t* p = static_cast<uint8_t*>(ws);
  float* qs = reinterpret_cast<float*>(p + (size_t)rows * Kp);
  return {p, qs, qs + (size_t)rows * (Kp / GS)};
}

// Programmatic dependent launch: the quantize kernel lets the tile kernel
// start (its weight copies need nothing quantized), and the tile kernel
// waits for the quantize kernel's writes before it reads them.
__device__ __forceinline__ void let_dependents_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Row r of x [rows, Kp] into q: eight codes a thread, so a row of Kp takes
// Kp / 8 threads a pass (quantize_threads). Every thread of the block
// calls it (it syncs); blockDim.x a multiple of 32, red: blockDim.x / 32
// floats of smem.
__device__ __forceinline__ void quantize_row(const __nv_bfloat16* __restrict__ x, int r,
                                             int rows, int Kp, Quantized q, float* red) {
  const int tid = threadIdx.x, lane = tid & 31;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)r * Kp);
  float mx = 0.f;
  for (int i = tid; i < Kp / 8; i += blockDim.x) {
    const uint4 v = __ldg(xr + i);
    const uint32_t xw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx = fmaxf(mx, fmaxf(fabsf(lo_bf16(xw[e])), fabsf(hi_bf16(xw[e]))));
  }
  mx = warp_max(mx);
  if (lane == 0) red[tid >> 5] = mx;
  __syncthreads();
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) mx = fmaxf(mx, red[i]);
  float sx = __fdiv_rn(mx, 127.f);
  sx = sx == 0.f ? 1.f : sx;
  if (tid == 0) q.sx[r] = sx;
  // Word i (codes 8i .. 8i + 7) is word i % 4 of 32-code unit i / 4: its
  // even codes go to byte 4 (i % 4) of the unit, its odd codes 16 further.
  // A group's 16 words fall to 16 neighbouring lanes.
  for (int i0 = 0; i0 < Kp / 8; i0 += blockDim.x) {
    const int i = i0 + tid;
    int sum = 0;
    if (i < Kp / 8) {
      const uint4 v = __ldg(xr + i);
      const uint32_t xw[4] = {v.x, v.y, v.z, v.w};
      int c[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        c[2 * e] = quant_s8(lo_bf16(xw[e]), sx);
        c[2 * e + 1] = quant_s8(hi_bf16(xw[e]), sx);
        sum += c[2 * e] + c[2 * e + 1];
      }
      uint8_t* unit = q.xq + (size_t)r * Kp + 32 * (size_t)(i >> 2) + 4 * (i & 3);
      *reinterpret_cast<uint32_t*>(unit) = pack_s8x4(c[0], c[2], c[4], c[6]);
      *reinterpret_cast<uint32_t*>(unit + 16) = pack_s8x4(c[1], c[3], c[5], c[7]);
    }
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (i < Kp / 8 && (i & 15) == 0) q.qs[(size_t)(i >> 4) * rows + r] = (float)sum;
  }
}

// Threads for quantize_row: a pass over the row, up to 1024.
inline int quantize_threads(int Kp) { return Kp / 8 >= 1024 ? 1024 : (Kp / 8 + 31) / 32 * 32; }

// The tile's f32 sums before sx: [m tile][n8 tile][c], rows gid (+ 8 for
// c >= 2) of m tile i, columns 2 tig + (c & 1) of the warp's n8 tile j.
using Acc = float[2][2][4];

// One group of the tile's first NT m16 tiles: the codes of its xq rows
// (x: the stage's xq at the group, row stride XLD; qs: the group's code
// sums) against the warp's two n8 tiles of weight words wv, four k32 steps
// each, folded into acc with the columns' scales and biases. The NT x 2
// products of a k step are independent, so their IMMAs overlap.
template <int NT>
__device__ __forceinline__ void group_mma(const unsigned char* x, const float* qs,
                                          const uint32_t (&wv)[2][4], const float (&sc)[2][2],
                                          const float (&bi)[2][2], int gid, int tig, Acc& acc) {
  uint32_t xa[NT][4][4];  // rows gid / gid + 8, even / odd codes, k32 steps 0-3
#pragma unroll
  for (int mt = 0; mt < NT; ++mt)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          x + (mt * 16 + gid + (h & 1) * 8) * XLD + tig * 32 + (h >> 1) * 16);
      xa[mt][h][0] = v.x;
      xa[mt][h][1] = v.y;
      xa[mt][h][2] = v.z;
      xa[mt][h][3] = v.w;
    }
  int d[NT][2][4] = {};
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int mt = 0; mt < NT; ++mt) {
      const uint32_t a[4] = {xa[mt][0][k], xa[mt][1][k], xa[mt][2][k], xa[mt][3][k]};
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mma_s8_16832(d[mt][j], a, wv[j][k] & 0x0F0F0F0Fu, (wv[j][k] >> 4) & 0x0F0F0F0Fu);
    }
#pragma unroll
  for (int mt = 0; mt < NT; ++mt) {
    const float q0 = qs[mt * 16 + gid], q1 = qs[mt * 16 + gid + 8];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[mt][j][c] += (float)d[mt][j][c] * sc[j][c & 1] + (c < 2 ? q0 : q1) * bi[j][c & 1];
  }
}

// Rows [m0, min(m0 + BM, m_end)) of q (`rows` rows in all; rows past the
// tile's load as zeros), columns [n0, min(n0 + BN, N)) of the weights w
// [N, Kp / 8], s and b [N, Kp / GS], groups [g0, g1): adds into acc, and
// stages the rows' sx for tile_store. THREADS threads; smem: SMEM_BYTES.
// Every thread calls it (it syncs). The weights' first copies are issued
// before the wait for the quantize kernel (wait_for_prerequisites).
__device__ __forceinline__ void tile_mma(Quantized q, int rows, const uint32_t* __restrict__ w,
                                         const __nv_bfloat16* __restrict__ s,
                                         const __nv_bfloat16* __restrict__ b, int m0, int m_end,
                                         int n0, int N, int Kp, int g0, int g1,
                                         unsigned char* smem, Acc& acc) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int G = Kp / GS, ng = g1 - g0;
  const uint32_t ring = smem_u32(smem);
  uint32_t* sb_s = reinterpret_cast<uint32_t*>(smem + RING_BYTES);  // [SB_GROUPS][BN]: s | b << 16
  float* sx_s = reinterpret_cast<float*>(smem + RING_BYTES + SB_GROUPS * BN * 4);
  const bool two = m_end - m0 > 16;  // the second m16 tile holds rows

  auto load_weights = [&](int i) {  // group g0 + i's weights into slot i % STAGES
    const uint32_t st = ring + (i % STAGES) * STAGE_BYTES;
#pragma unroll
    for (int k = 0; k < W_BYTES / 16 / THREADS; ++k) {
      const int c = tid + k * THREADS, r = c >> 2;
      const bool ok = n0 + r < N;
      cp_async16(st + c * 16,
                 ok ? w + (size_t)(n0 + r) * (Kp / 8) + (g0 + i) * 16 + (c & 3) * 4 : w,
                 ok ? 16 : 0);
    }
  };
  auto load_codes = [&](int i) {  // its codes and code sums
    const uint32_t st = ring + (i % STAGES) * STAGE_BYTES;
    {
      const int r = tid >> 3;  // BM rows x 8 chunks: one a thread
      const bool ok = m0 + r < m_end;
      cp_async16(st + W_BYTES + r * XLD + (tid & 7) * 16,
                 ok ? q.xq + (size_t)(m0 + r) * Kp + (size_t)(g0 + i) * GS + (tid & 7) * 16
                    : q.xq,
                 ok ? 16 : 0);
    }
    if (tid < BM) {
      const bool ok = m0 + tid < m_end;
      cp_async4(st + W_BYTES + X_BYTES + tid * 4,
                ok ? q.qs + (size_t)(g0 + i) * rows + m0 + tid : q.qs, ok ? 4 : 0);
    }
  };
  // Groups [gl, gl + SB_GROUPS) of scales and biases: loaded to registers
  // (every load in flight at once), then stored to smem.
  constexpr int SB_PER = SB_GROUPS * BN / THREADS;
  uint32_t sbv[SB_PER];
  auto load_sb = [&](int gl) {
#pragma unroll
    for (int k = 0; k < SB_PER; ++k) {
      const int e = tid + k * THREADS, c = e / SB_GROUPS, j = e % SB_GROUPS;
      sbv[k] = 0;
      if (n0 + c < N && gl + j < ng) {
        const size_t o = (size_t)(n0 + c) * G + g0 + gl + j;
        sbv[k] = (uint32_t)__bfloat16_as_ushort(s[o]) |
                 ((uint32_t)__bfloat16_as_ushort(b[o]) << 16);
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

  // The weights of the first stages and their scales, then (once the
  // quantize kernel is done) the codes, code sums and sx: commit group k
  // holds stage k's codes. The scales reach smem while the copies fly.
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i)
    if (i < ng) load_weights(i);
  load_sb(0);
  wait_for_prerequisites();
  if (tid < BM) {
    const bool ok = m0 + tid < m_end;
    cp_async4(smem_u32(sx_s + tid), ok ? q.sx + m0 + tid : q.sx, ok ? 4 : 0);
  }
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ng) load_codes(i);
    cp_async_commit();
  }
  store_sb();
  for (int i = 0; i < ng; ++i) {
    if (i % SB_GROUPS == 0 && i > 0) {
      load_sb(i);
      __syncthreads();  // every warp is done with the last chunk
      store_sb();
    }
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slot i % STAGES landed; slot (i - 1) % STAGES is free; sb staged
    if (i + STAGES - 1 < ng) {
      load_weights(i + STAGES - 1);
      load_codes(i + STAGES - 1);
    }
    cp_async_commit();

    const unsigned char* st = smem + (i % STAGES) * STAGE_BYTES;
    uint32_t wv[2][4];
    float sc[2][2], bi[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint4 v =
          *reinterpret_cast<const uint4*>(st + (warp * 16 + j * 8 + gid) * 64 + tig * 16);
      wv[j][0] = v.x;
      wv[j][1] = v.y;
      wv[j][2] = v.z;
      wv[j][3] = v.w;
      const uint2 sb = *reinterpret_cast<const uint2*>(sb_s + i % SB_GROUPS * BN + warp * 16 +
                                                       j * 8 + tig * 2);
      sc[j][0] = lo_bf16(sb.x);
      bi[j][0] = hi_bf16(sb.x);
      sc[j][1] = lo_bf16(sb.y);
      bi[j][1] = hi_bf16(sb.y);
    }
    const float* qs_s = reinterpret_cast<const float*>(st + W_BYTES + X_BYTES);
    if (two)
      group_mma<2>(st + W_BYTES, qs_s, wv, sc, bi, gid, tig, acc);
    else
      group_mma<1>(st + W_BYTES, qs_s, wv, sc, bi, gid, tig, acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the partial tile
}

// The output tile of tile_mma's sums over the `nrank` blocks of the
// cluster (each one k-range; nrank 1: the block alone), added in rank order:
// out[m, n] = bf16(sx[m] * sum (+ res[m, n])) for the tile's rows below
// m_end and columns below N. The partial tiles meet in shared memory; this
// block stores the 4-column chunks rank, rank + nrank, ..., reading each
// chunk of every rank (distributed shared memory) in one round. Every
// thread of every block of the cluster calls it (it syncs the cluster, or
// the block when nrank is 1).
__device__ __forceinline__ void tile_store(const Acc& acc, const __nv_bfloat16* __restrict__ res,
                                           __nv_bfloat16* __restrict__ out, int m0, int m_end,
                                           int n0, int N, int rank, int nrank,
                                           unsigned char* smem) {
  namespace cg = cooperative_groups;
  constexpr int CHUNKS = BM * BN / 4, MAX_RANKS = 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  float* part = reinterpret_cast<float*>(smem);
  const float* sx_s = reinterpret_cast<const float*>(smem + RING_BYTES + SB_GROUPS * BN * 4);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(part + (mt * 16 + gid + h * 8) * PLD + warp * 16 + j * 8 +
                                   tig * 2) = make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
  cg::cluster_group cluster = cg::this_cluster();
  if (nrank == 1)
    __syncthreads();
  else
    cluster.sync();  // the partial tiles are published
  const int nown = (CHUNKS - rank + nrank - 1) / nrank;
#pragma unroll
  for (int u = 0; u < CHUNKS / THREADS; ++u) {
    const int i = tid + u * THREADS, c = rank + i * nrank;
    const int r = c / (BN / 4), n = n0 + c % (BN / 4) * 4, m = m0 + r;
    if (i >= nown || m >= m_end || n >= N) continue;
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
    const float sx = sx_s[r];
    const float y[4] = {sum.x * sx + rv[0], sum.y * sx + rv[1], sum.z * sx + rv[2],
                        sum.w * sx + rv[3]};
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
  // No block leaves, or refills its ring for a next tile, while others
  // read its partial tile; the readers' loads are done when they arrive.
  if (nrank == 1) {
    __syncthreads();
  } else {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\nbarrier.cluster.wait.aligned;\n" :::
                     "memory");
  }
}

// The SMs of the current device (queried once).
inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// Launch a tile kernel on `grid` in clusters of `ranks` blocks along x,
// THREADS threads and SMEM_BYTES of dynamic shared memory a block (the
// caller allows the kernel that much first), as a programmatic dependent
// of the quantize kernel launched just before it on `st`.
template <class... Params, class... Args>
cudaError_t launch_tile(void (*kernel)(Params...), dim3 grid, int ranks, cudaStream_t st,
                        Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = ranks;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace a8

}  // namespace qmm
