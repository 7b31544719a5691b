// The dequant-fused matmul bodies shared by K1 and the any-width kernel
// (quant_matmul.cu, quant_matmul_sg.cu) and by the grouped expert matmuls
// (moe_matmul.cu, moe_matmul_sg.cu). Each runs over one weight matrix (w,
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
//  * tile: a 64x64 output tile per 4-warp block, KU = 128 k (128 / GSZ
//    groups) per shared-memory stage. Codes go to shared memory as exact
//    bf16 integers (up to 255), the products q.x run on tensor cores
//    (mma.sync m16n8k16, f32 accumulate) and the per-group fold d*s + xs*b
//    happens in registers, so no bf16 rounding of q*s occurs (the TPU
//    kernels round q*s, then + b, to bf16). No async copies or double
//    buffering yet.
//  * gemv_a8_rows (W4 g128 only): the W4A8 GEMV. The block quantizes its
//    MT x rows to int8 in shared memory first (per-row absmax, the JAX
//    package's arithmetic), then gemv_rows's schedule with integer dots:
//    `w & 0x0F0F0F0F` holds a word's even-k codes as bytes and
//    `(w >> 4) & 0x0F0F0F0F` its odd-k codes, and xq is stored even/odd
//    interleaved to match, so two __dp4a give one word's 8-code dot.
#pragma once

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

constexpr int BM = 64, BN = 64, PAD = 8, LDS = KU + PAD;  // smem row: 136 bf16

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 64x64 output tile at rows m0.., columns n0..; rows at or past m_end
// are not read (they load as 0) and not written. 128 threads.
template <int BITS = 4, int GSZ = GS>
__device__ __forceinline__ void tile(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out,
    int m0, int n0, int m_end, int N, int Kp) {
  constexpr int VPW = 32 / BITS;      // codes per word
  constexpr int CHUNK = 4 * VPW;      // codes per 16-byte chunk
  constexpr int CPR = KU / CHUNK;     // 16-byte chunks per weight row and stage
  constexpr int NGS = KU / GSZ;       // groups per stage
  constexpr int KPG = GSZ / 16;       // mma k-steps per group
  constexpr uint32_t MASK = (1u << BITS) - 1;
  __shared__ __align__(16) __nv_bfloat16 Xs[BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 Ws[BN * LDS];
  __shared__ float xs_s[NGS][BM], sc_s[NGS][BN], bi_s[NGS][BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 2x2 warps, 32x32 each
  const int gid = lane >> 2, tig = lane & 3;
  const int G = Kp / GSZ;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  for (int g = 0; g < Kp / KU; ++g) {  // stage g: k in [g * KU, (g + 1) * KU)
    // x tile: 64 rows x 128 bf16 = 1024 16-byte chunks, 8 per thread.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + i * 128;
      const int r = idx >> 4, cc = idx & 15;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + r < m_end)
        v = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * Kp + g * KU) + cc);
      *reinterpret_cast<uint4*>(&Xs[r * LDS + cc * 8]) = v;
    }
    // w tile: 64 rows x CPR 16-byte chunks (256 at W4: 2 per thread); each
    // expands to CHUNK bf16 codes.
#pragma unroll
    for (int i = 0; i < BN * CPR / 128; ++i) {
      const int idx = tid + i * 128;
      const int r = idx >> ilog2(CPR), cc = idx & (CPR - 1);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (n0 + r < N)
        v = __ldg(reinterpret_cast<const uint4*>(w + (size_t)(n0 + r) * (Kp / VPW) +
                                                 g * (KU / VPW)) + cc);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
      uint32_t packed2[2 * VPW];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < VPW / 2; ++e) {
          // bf16 of a small integer q is 0x4300 | q for 128 + q; exact
          // conversion through float is simpler and just as exact.
          const uint32_t q0 = (words[t] >> (2 * BITS * e)) & MASK;
          const uint32_t q1 = (words[t] >> (2 * BITS * e + BITS)) & MASK;
          const uint32_t h0 = __bfloat16_as_ushort(__float2bfloat16_rn((float)q0));
          const uint32_t h1 = __bfloat16_as_ushort(__float2bfloat16_rn((float)q1));
          packed2[t * (VPW / 2) + e] = h0 | (h1 << 16);
        }
      uint4* dst = reinterpret_cast<uint4*>(&Ws[r * LDS + cc * CHUNK]);
#pragma unroll
      for (int t = 0; t < VPW / 2; ++t)
        dst[t] = make_uint4(packed2[4 * t], packed2[4 * t + 1], packed2[4 * t + 2],
                            packed2[4 * t + 3]);
    }
    if (tid < BN) {
      const bool ok = n0 + tid < N;
#pragma unroll
      for (int gi = 0; gi < NGS; ++gi) {
        sc_s[gi][tid] = ok ? bf2f(s[(size_t)(n0 + tid) * G + g * NGS + gi]) : 0.f;
        bi_s[gi][tid] = ok ? bf2f(b[(size_t)(n0 + tid) * G + g * NGS + gi]) : 0.f;
      }
    }
    __syncthreads();
    {
      // Group sums of x: two threads per row, 64 values each (one group
      // at g64, two at g32, half of one at g128).
      constexpr int PER = GSZ < 64 ? GSZ : 64;  // values per partial sum
      const int r = tid >> 1, half = tid & 1;
      const uint4* src = reinterpret_cast<const uint4*>(&Xs[r * LDS + half * 64]);
      float sum[64 / PER];
#pragma unroll
      for (int j = 0; j < 64 / PER; ++j) sum[j] = 0.f;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const uint4 v = src[t];
        const uint32_t xw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[t * 8 / PER] += lo_bf16(xw[e]) + hi_bf16(xw[e]);
      }
      if constexpr (GSZ == KU) {
        sum[0] += __shfl_xor_sync(0xffffffffu, sum[0], 1);
        if (half == 0) xs_s[0][r] = sum[0];
      } else {
#pragma unroll
        for (int j = 0; j < 64 / PER; ++j) xs_s[half * (64 / PER) + j][r] = sum[j];
      }
    }
    if constexpr (NGS > 1) __syncthreads();  // xs_s written before the folds read it

    const uint32_t* Xw = reinterpret_cast<const uint32_t*>(Xs);
    const uint32_t* Ww = reinterpret_cast<const uint32_t*>(Ws);
    constexpr int LDW = LDS / 2;  // words per smem row
#pragma unroll
    for (int gi = 0; gi < NGS; ++gi) {
      float d[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) d[i][j][c] = 0.f;
#pragma unroll
      for (int kk = gi * KPG; kk < (gi + 1) * KPG; ++kk) {
        const int kw = kk * 8 + tig;  // word column of k = kk*16 + 2*tig
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = wm * 32 + i * 16 + gid;
          a[i][0] = Xw[r * LDW + kw];
          a[i][1] = Xw[(r + 8) * LDW + kw];
          a[i][2] = Xw[r * LDW + kw + 4];
          a[i][3] = Xw[(r + 8) * LDW + kw + 4];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nr = wn * 32 + j * 8 + gid;
          const uint32_t b0 = Ww[nr * LDW + kw];
          const uint32_t b1 = Ww[nr * LDW + kw + 4];
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_bf16_16816(d[i][j], a[i], b0, b1);
        }
      }
      if constexpr (NGS == 1) __syncthreads();  // xs_s written before the fold reads it
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int r = wm * 32 + i * 16 + gid + (c >= 2 ? 8 : 0);
            const int col = wn * 32 + j * 8 + tig * 2 + (c & 1);
            acc[i][j][c] += d[i][j][c] * sc_s[gi][col] + xs_s[gi][r] * bi_s[gi][col];
          }
    }
    __syncthreads();  // before the next stage overwrites the tiles
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = m0 + wm * 32 + i * 16 + gid + (c >= 2 ? 8 : 0);
        const int n = n0 + wn * 32 + j * 8 + tig * 2 + (c & 1);
        if (m < m_end && n < N) {
          float y = acc[i][j][c];
          if (res != nullptr) y += bf2f(res[(size_t)m * N + n]);
          out[(size_t)m * N + n] = __float2bfloat16_rn(y);
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

}  // namespace qmm
