// The W4A16 group-128 dequant-fused matmul bodies shared by K1
// (quant_matmul.cu) and the grouped expert matmul (moe_matmul.cu). Each
// runs over one weight matrix (w, s, b point at its first row) and over a
// range of x rows, so K1 passes [0, M) and the grouped kernel an expert's
// segment of the sorted rows.
//
// Weights (ops/quantize.py layout): packed int32 [N, Kp/8], eight
// consecutive k codes per word, code j in bits [4j, 4j+4); scales/biases
// bf16 [N, G]. x is bf16 [*, Kp]. out[m, n] = bf16( sum_k x[m, k] *
// (q[n, k] * s[n, g] + b[n, g]) (+ res[m, n]) ), f32 accumulation, the
// residual added in f32 before the bf16 round.
//
//  * gemv_rows: one warp per output row n; each lane streams 16 bytes (32
//    codes, a quarter of one group) per step, so a warp reads 512
//    contiguous bytes of the row. Per lane and x row it accumulates
//    d = sum x*q and xs = sum x over its 32 codes and folds
//    acc += d*s + xs*b — the TPU decode schedule's scale/bias fold, done
//    in f32. Up to MT x rows share one pass over the weights.
//  * tile: a 64x64 output tile per 4-warp block, one group (128 k) per
//    shared-memory stage. Codes go to shared memory as exact bf16
//    integers, the products q.x run on tensor cores (mma.sync m16n8k16,
//    f32 accumulate) and the per-group fold d*s + xs*b happens in
//    registers, so no bf16 rounding of q*s occurs (the TPU staged schedule
//    rounds q*s to bf16). No async copies or double buffering yet.
#pragma once

#include "common.cuh"

namespace qmm {

constexpr int GS = 128;  // group size

// Rows m in [m0, min(m0 + MT, m_end)) of out; warp w of the block takes
// column n = blockIdx.x * warps + w (none past N). 256 threads.
template <int MT>
__device__ __forceinline__ void gemv_rows(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out,
    int m0, int m_end, int N, int Kp) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= N) return;
  const int G = Kp / GS;
  const int nchunks = Kp / 32;  // 16-byte chunks of 32 codes
  const uint4* wrow = reinterpret_cast<const uint4*>(w + (size_t)n * (Kp / 8));
  const __nv_bfloat16* srow = s + (size_t)n * G;
  const __nv_bfloat16* brow = b + (size_t)n * G;

  float acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i] = 0.f;

  for (int c = lane; c < nchunks; c += 32) {
    const uint4 wv = __ldg(wrow + c);
    const int g = c >> 2;
    const float sc = bf2f(srow[g]);
    const float bi = bf2f(brow[g]);
    const uint32_t words[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      if (m0 + mi < m_end) {
        const uint4* xr =
            reinterpret_cast<const uint4*>(x + (size_t)(m0 + mi) * Kp + (size_t)c * 32);
        float d = 0.f, xs = 0.f;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint4 xv = __ldg(xr + t);
          const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x0 = lo_bf16(xw[e]);
            const float x1 = hi_bf16(xw[e]);
            const float q0 = (float)((words[t] >> (8 * e)) & 0xF);
            const float q1 = (float)((words[t] >> (8 * e + 4)) & 0xF);
            d += x0 * q0 + x1 * q1;
            xs += x0 + x1;
          }
        }
        acc[mi] += d * sc + xs * bi;
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

constexpr int BM = 64, BN = 64, PAD = 8, LDS = GS + PAD;  // smem row: 136 bf16

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
__device__ __forceinline__ void tile(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out,
    int m0, int n0, int m_end, int N, int Kp) {
  __shared__ __align__(16) __nv_bfloat16 Xs[BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 Ws[BN * LDS];
  __shared__ float xs_s[BM], sc_s[BN], bi_s[BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 2x2 warps, 32x32 each
  const int gid = lane >> 2, tig = lane & 3;
  const int G = Kp / GS;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    // x tile: 64 rows x 128 bf16 = 1024 16-byte chunks, 8 per thread.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + i * 128;
      const int r = idx >> 4, cc = idx & 15;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + r < m_end)
        v = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * Kp + g * GS) + cc);
      *reinterpret_cast<uint4*>(&Xs[r * LDS + cc * 8]) = v;
    }
    // w tile: 64 rows x 16 words = 256 16-byte chunks, 2 per thread; each
    // expands to 32 bf16 codes.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * 128;
      const int r = idx >> 2, cc = idx & 3;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (n0 + r < N)
        v = __ldg(reinterpret_cast<const uint4*>(w + (size_t)(n0 + r) * (Kp / 8) + g * 16) + cc);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
      uint32_t packed2[16];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // bf16 of a small integer q is 0x4300 | q for 128 + q; exact
          // conversion through float is simpler and just as exact.
          const uint32_t q0 = (words[t] >> (8 * e)) & 0xF;
          const uint32_t q1 = (words[t] >> (8 * e + 4)) & 0xF;
          const uint32_t h0 = __bfloat16_as_ushort(__float2bfloat16_rn((float)q0));
          const uint32_t h1 = __bfloat16_as_ushort(__float2bfloat16_rn((float)q1));
          packed2[t * 4 + e] = h0 | (h1 << 16);
        }
      uint4* dst = reinterpret_cast<uint4*>(&Ws[r * LDS + cc * 32]);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        dst[t] = make_uint4(packed2[4 * t], packed2[4 * t + 1], packed2[4 * t + 2],
                            packed2[4 * t + 3]);
    }
    if (tid < BN) {
      const bool ok = n0 + tid < N;
      sc_s[tid] = ok ? bf2f(s[(size_t)(n0 + tid) * G + g]) : 0.f;
      bi_s[tid] = ok ? bf2f(b[(size_t)(n0 + tid) * G + g]) : 0.f;
    }
    __syncthreads();
    {
      // Group sums of x: two threads per row, 64 values each.
      const int r = tid >> 1, half = tid & 1;
      const uint4* src = reinterpret_cast<const uint4*>(&Xs[r * LDS + half * 64]);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const uint4 v = src[t];
        const uint32_t xw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) sum += lo_bf16(xw[e]) + hi_bf16(xw[e]);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (half == 0) xs_s[r] = sum;
    }

    float d[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) d[i][j][c] = 0.f;

    const uint32_t* Xw = reinterpret_cast<const uint32_t*>(Xs);
    const uint32_t* Ww = reinterpret_cast<const uint32_t*>(Ws);
    constexpr int LDW = LDS / 2;  // words per smem row
#pragma unroll
    for (int kk = 0; kk < GS / 16; ++kk) {
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
    __syncthreads();  // xs_s written before the fold reads it
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = wm * 32 + i * 16 + gid + (c >= 2 ? 8 : 0);
          const int col = wn * 32 + j * 8 + tig * 2 + (c & 1);
          acc[i][j][c] += d[i][j][c] * sc_s[col] + xs_s[r] * bi_s[col];
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

}  // namespace qmm
