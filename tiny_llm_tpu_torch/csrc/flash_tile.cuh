// Causal flash-attention tile of K3 (flash_attention.cu, K/V in a dense
// slab; row 4's L <= 16 calls take it too). Where a key row lives is the
// `Rows` functor of common.cuh.
//
// One block holds ROWS = 8 * RPW query rows: the KV head's NREP query heads
// times BQ = ROWS / NREP consecutive positions, so each K/V tile loaded into
// shared memory serves every query head that shares it. Query i of batch
// row bb sits at position len - L + i and sees keys at positions <= its
// own. Key tiles of 32 positions: each lane scores one key for the warp's
// RPW rows (K rows padded one word in shared memory so lanes hit distinct
// banks), the warp updates its rows' online-softmax states with shuffles,
// and the PV product runs with each lane owning D/32 output dims. Tiles past
// the q tile's last visible key are never loaded, and nothing at or past
// `limit` (the slab length) is read. A row that sees no key emits 0, not NaN (NEG_INF = -1e30 with the
// NEG_INF/2 floor on the subtrahend).
//
// Rounding points follow the TPU kernels (flash_attention_pallas.py
// _flash_inner): q * scale rounds to bf16, scores and the softmax state are
// f32, probabilities round to bf16 for the PV product, the output is
// acc / max(l, 1e-30) rounded to bf16. SIMT only; the split prefill's two
// kernels run flash_mma.cuh's tensor-core tile instead.
#pragma once

#include "common.cuh"

namespace flash {

constexpr int WARPS = 8, KT = 32;

template <int D, int NREP, int RPW, class Rows>
__device__ __forceinline__ void tile(
    const __nv_bfloat16* __restrict__ q,  // [B, Hq, L, D]
    const __nv_bfloat16* __restrict__ k,  // base of the rows `rows` addresses
    const __nv_bfloat16* __restrict__ v,
    __nv_bfloat16* __restrict__ out,  // [B, Hq, L, D]
    const Rows rows, int len, int limit, int qt, int h, int bb, int Hkv, int L,
    float scale) {
  constexpr int ROWS = WARPS * RPW, BQ = ROWS / NREP, DPL = D / 32;
  constexpr int KW = D / 2 + 1;  // padded K row, words
  static_assert(ROWS % NREP == 0, "a q tile holds whole query heads");
  __shared__ __align__(16) __nv_bfloat16 Qs[ROWS][D];
  __shared__ uint32_t Ks[KT][KW];
  __shared__ __align__(16) __nv_bfloat16 Vs[KT][D];
  __shared__ float Ps[WARPS][RPW][KT];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * NREP;
  const int q0 = qt * BQ;

  // Load the tile's query rows, pre-scaled and rounded to bf16.
  for (int idx = tid; idx < ROWS * D; idx += blockDim.x) {
    const int rr = idx / D, d = idx % D;
    const int rep = rr / BQ, qi = q0 + rr % BQ;
    float val = 0.f;
    if (qi < L) val = bf2f(q[(((size_t)bb * Hq + h * NREP + rep) * L + qi) * D + d]);
    Qs[rr][d] = __float2bfloat16_rn(val * scale);
  }

  int qpos[RPW];
  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int rr = warp * RPW + i;
    const int qi = q0 + rr % BQ;
    qpos[i] = qi < L ? len - L + qi : -1;  // -1: padding row, sees nothing
    m[i] = TLT_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
  }
  // Keys visible to the tile's last row, clamped to the row's length and
  // to what the slab or block table holds.
  const int kmax = min(min(len, len - L + min(q0 + BQ, L)), limit);

  for (int t0 = 0; t0 < kmax; t0 += KT) {
    __syncthreads();  // previous tile consumed (and Qs written)
    for (int idx = tid; idx < KT * D / 8; idx += blockDim.x) {
      const int j = idx / (D / 8), c = idx % (D / 8);
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (t0 + j < kmax) {
        const size_t o = rows(t0 + j);
        kv4 = __ldg(reinterpret_cast<const uint4*>(k + o) + c);
        vv4 = __ldg(reinterpret_cast<const uint4*>(v + o) + c);
      }
      Ks[j][c * 4 + 0] = kv4.x;
      Ks[j][c * 4 + 1] = kv4.y;
      Ks[j][c * 4 + 2] = kv4.z;
      Ks[j][c * 4 + 3] = kv4.w;
      *reinterpret_cast<uint4*>(&Vs[j][c * 8]) = vv4;
    }
    __syncthreads();

    // Scores: lane = key, for the warp's RPW rows.
    float sc[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) sc[i] = 0.f;
    const uint32_t* Qw = reinterpret_cast<const uint32_t*>(&Qs[warp * RPW][0]);
#pragma unroll 4
    for (int c = 0; c < D / 2; ++c) {
      const uint32_t kw = Ks[lane][c];
      const float k0 = lo_bf16(kw), k1 = hi_bf16(kw);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const uint32_t qw = Qw[i * (D / 2) + c];
        sc[i] += lo_bf16(qw) * k0 + hi_bf16(qw) * k1;
      }
    }
    const int kpos = t0 + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const bool seen = kpos <= qpos[i];
      const float s_i = seen ? sc[i] : TLT_NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(s_i));
      const float alpha = expf(m[i] - m_new);
      const float p = expf(s_i - fmaxf(m_new, TLT_NEG_INF / 2));
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[i][e] *= alpha;
      Ps[warp][i][lane] = round_bf16(p);
    }
    __syncwarp();
    const int nk = min(KT, kmax - t0);
    for (int j = 0; j < nk; ++j) {
      float vv[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) vv[e] = bf2f(Vs[j][lane * DPL + e]);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float pj = Ps[warp][i][j];
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[i][e] += pj * vv[e];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int rr = warp * RPW + i;
    const int rep = rr / BQ, qi = q0 + rr % BQ;
    if (qi >= L) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* o = out + (((size_t)bb * Hq + h * NREP + rep) * L + qi) * D + lane * DPL;
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[e] = __float2bfloat16_rn(acc[i][e] * inv);
  }
}

}  // namespace flash
