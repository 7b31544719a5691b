// K2 and its paged twin: the fused decode attention step for Hopper
// (sm_90a), over a dense slab (tlt_fused_decode_attention) or over one
// layer's page pool through a block table (tlt_fused_paged_decode_attention).
//
// Replaces tiny_llm_tpu/kernels/fused_decode_attention.py::_fused_step_kernel
// (through fused_decode_attention) and ::_fused_paged_step_kernel (through
// fused_paged_decode_attention). For one layer and one decode step it
// splits the per-KV-head interleaved qkv row, applies QK-RMSNorm and RoPE,
// runs an online softmax over the cached positions [0, off) and folds the
// current token's own k/v in last. It returns the attention rows and the
// normed+roped k row and the raw v row, which the caller writes into the
// slab or the pages in place.
//
// Rounding points follow the TPU kernels: the normalized value rounds to
// bf16 before the weight multiply, RoPE rotates in f32 and rounds to bf16,
// q is pre-scaled and rounded to bf16, probabilities round to bf16 for the
// PV product while the denominator sums them in f32, and the current
// token's probability rounds to bf16 too.
//
// Bound on the H100: the bytes of the cached K and V rows in [0, off) plus
// the qkv row, over 3.35 TB/s — a few microseconds at 4B's shapes, so the
// launch and the serial prologue dominate.
//
// Design: one block per (b, kv head), 8 warps. Warp w takes key tiles of 32
// positions (w, w + 8, ...): each lane looks up where its key row lives
// (SlabRows / PageRows of common.cuh: for the pool, bt[b, pos / ps] and
// pos % ps), scores that key against all n_rep query rows held in shared
// memory, the warp updates its (m, l, acc) with shuffles, and the PV
// product runs with each lane owning D/32 output dims, the row offsets
// broadcast by shuffle. The walk stops at off (and at the block table's
// width), so the -1 entries past a row's live pages are never read. The 8
// warp states merge in shared memory, then the current token folds in.
// Known weakness: at B = 1 the grid is Hkv = 8 blocks on 132 SMs.
//
// tlt_fused_qkv_prep replaces
// tiny_llm_tpu/kernels/fused_decode_attention.py::_qkv_prep_kernel (through
// fused_qkv_prep): K2's prologue alone, for the three-launch paged decode
// (prep, the page write, then the paged decode kernel reads the pages with
// the current token already in them). It returns q normed and roped but
// NOT scaled (K2 keeps q pre-scaled; the attention kernel scales it), the
// normed and roped k row and the raw v row, at K2's rounding points. A
// kernel of its own rather than an option of fused_step, so K2's and the
// paged twin's machine code stay as they were. Bound on the H100: it moves
// B * Hkv * (2 * n_rep + 4) * D * 2 bytes (36 KB at Qwen3-4B's heads and B
// = 4), 0.01 us at 3.35 TB/s; the launch bounds it. One block per (b, kv
// head), a warp per row.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;

template <int D, int NREP, class Rows>
__device__ __forceinline__ void fused_step(
    const __nv_bfloat16* __restrict__ qkv,  // [B, Hkv, NREP + 2, D]
    const __nv_bfloat16* __restrict__ keys,  // base of the rows `rows` addresses
    const __nv_bfloat16* __restrict__ values,
    const Rows rows, int off, int limit,
    const float* __restrict__ cos_row, const float* __restrict__ sin_row,  // [B, D/2]
    const __nv_bfloat16* __restrict__ qw, const __nv_bfloat16* __restrict__ kw,  // [D]
    __nv_bfloat16* __restrict__ out,    // [B, Hkv, NREP, D]
    __nv_bfloat16* __restrict__ k_out,  // [B, Hkv, D]
    __nv_bfloat16* __restrict__ v_out,  // [B, Hkv, D]
    int h, int bb, int Hkv, float scale, float eps) {
  constexpr int HALF = D / 2, DPL = D / 32;
  __shared__ float xrow[NREP + 1][D];  // normed rows before RoPE
  __shared__ float qs[NREP][D];        // pre-scaled q (bf16 values)
  __shared__ float kcur[D], vcur[D];
  __shared__ float scur[NREP];
  __shared__ float wm_s[WARPS][NREP], wl_s[WARPS][NREP];
  __shared__ float wacc[WARPS][NREP][D];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const __nv_bfloat16* row = qkv + (size_t)(bb * Hkv + h) * (NREP + 2) * D;
  const float* cs = cos_row + (size_t)bb * HALF;
  const float* sn = sin_row + (size_t)bb * HALF;

  // QK-RMSNorm: warp r normalizes row r (q rows 0..NREP-1, k row NREP).
  for (int r = warp; r <= NREP; r += WARPS) {
    const __nv_bfloat16* wt = r < NREP ? qw : kw;
    float v[DPL];
    float ss = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      v[e] = bf2f(row[r * D + lane + 32 * e]);
      ss += v[e] * v[e];
    }
    const float inv = rsqrtf(warp_sum(ss) / D + eps);
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const float normed = round_bf16(__fmul_rn(v[e], inv));
      xrow[r][lane + 32 * e] = round_bf16(__fmul_rn(normed, bf2f(wt[lane + 32 * e])));
    }
  }
  if (tid < D) vcur[tid] = bf2f(row[(NREP + 1) * D + tid]);
  __syncthreads();
  // RoPE (f32 rotate, bf16 round), q pre-scale.
  for (int idx = tid; idx < (NREP + 1) * HALF; idx += blockDim.x) {
    const int r = idx / HALF, i = idx % HALF;
    const float x1 = xrow[r][i], x2 = xrow[r][i + HALF];
    const float c = cs[i], sv = sn[i];
    const float re = round_bf16(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, sv)));
    const float im = round_bf16(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, sv)));
    if (r < NREP) {
      qs[r][i] = round_bf16(re * scale);
      qs[r][i + HALF] = round_bf16(im * scale);
    } else {
      kcur[i] = re;
      kcur[i + HALF] = im;
      const size_t o = (size_t)(bb * Hkv + h) * D;
      k_out[o + i] = __float2bfloat16_rn(re);
      k_out[o + i + HALF] = __float2bfloat16_rn(im);
    }
  }
  if (tid < D) v_out[(size_t)(bb * Hkv + h) * D + tid] = row[(NREP + 1) * D + tid];
  __syncthreads();
  // Score of the current token, one warp per q row.
  for (int r = warp; r < NREP; r += WARPS) {
    float p = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) p += qs[r][lane + 32 * e] * kcur[lane + 32 * e];
    p = warp_sum(p);
    if (lane == 0) scur[r] = p;
  }

  // Online softmax over the cached positions [0, n).
  const int n = min(off, limit);
  float m[NREP], l[NREP], acc[NREP][DPL];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    m[r] = TLT_NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }
  for (int t0 = warp * 32; t0 < n; t0 += WARPS * 32) {
    const int pos = t0 + lane;
    const unsigned long long my_row = pos < n ? rows(pos) : 0;
    float sc[NREP];
#pragma unroll
    for (int r = 0; r < NREP; ++r) sc[r] = 0.f;
    if (pos < n) {
      const uint4* kr = reinterpret_cast<const uint4*>(keys + my_row);
#pragma unroll 4
      for (int c = 0; c < D / 8; ++c) {
        const uint4 kv = __ldg(kr + c);
        const uint32_t kw4[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float k0 = lo_bf16(kw4[e]), k1 = hi_bf16(kw4[e]);
          const int d0 = c * 8 + 2 * e;
#pragma unroll
          for (int r = 0; r < NREP; ++r) sc[r] += qs[r][d0] * k0 + qs[r][d0 + 1] * k1;
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < NREP; ++r) sc[r] = TLT_NEG_INF;
    }
    float p[NREP];
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      const float m_new = fmaxf(m[r], warp_max(sc[r]));
      const float alpha = expf(m[r] - m_new);
      p[r] = expf(sc[r] - fmaxf(m_new, TLT_NEG_INF / 2));
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] *= alpha;
      p[r] = round_bf16(p[r]);
    }
    const int nvalid = min(32, n - t0);
    for (int j = 0; j < nvalid; ++j) {
      const unsigned long long rj = __shfl_sync(0xffffffffu, my_row, j);
      const __nv_bfloat16* vr = values + rj + lane * DPL;
      float vv[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) vv[e] = bf2f(vr[e]);
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] += pj * vv[e];
      }
    }
  }
  // Merge the warps' states.
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    if (lane == 0) {
      wm_s[warp][r] = m[r];
      wl_s[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) wacc[warp][r][lane * DPL + e] = acc[r][e];
  }
  __syncthreads();
  for (int idx = tid; idx < NREP * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D;
    float mg = TLT_NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mg = fmaxf(mg, wm_s[w][r]);
    float lg = 0.f, ag = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(wm_s[w][r] - mg);
      lg += wl_s[w][r] * f;
      ag += wacc[w][r][d] * f;
    }
    // Fold the current token (always visible to its own query).
    const float s_cur = scur[r];
    const float m_new = fmaxf(mg, s_cur);
    const float alpha = expf(mg - m_new);
    const float pc = expf(s_cur - m_new);
    const float lt = lg * alpha + pc;
    const float at = ag * alpha + round_bf16(pc) * vcur[d];
    out[((size_t)(bb * Hkv + h) * NREP + r) * D + d] = __float2bfloat16_rn(at / lt);
  }
}

template <int D, int NREP>
__global__ void __launch_bounds__(WARPS * 32) fused_decode_step(
    const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ keys,
    const __nv_bfloat16* __restrict__ values,  // [layers, B, Hkv, S, D]
    const int* __restrict__ offsets, const float* __restrict__ cs, const float* __restrict__ sn,
    const __nv_bfloat16* __restrict__ qw, const __nv_bfloat16* __restrict__ kw,
    __nv_bfloat16* __restrict__ out, __nv_bfloat16* __restrict__ k_out,
    __nv_bfloat16* __restrict__ v_out, int layer, int B, int Hkv, int S, float scale,
    float eps) {
  const int h = blockIdx.x, bb = blockIdx.y;
  const SlabRows<D> rows{((size_t)(layer * B + bb) * Hkv + h) * (size_t)S * D};
  fused_step<D, NREP>(qkv, keys, values, rows, offsets[bb], S, cs, sn, qw, kw, out, k_out,
                      v_out, h, bb, Hkv, scale, eps);
}

template <int D, int NREP>
__global__ void __launch_bounds__(WARPS * 32) fused_paged_step(
    const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp,  // [P, Hkv, ps, D]
    const int* __restrict__ bt,            // [B, maxp], -1 padded
    const int* __restrict__ offsets, const float* __restrict__ cs, const float* __restrict__ sn,
    const __nv_bfloat16* __restrict__ qw, const __nv_bfloat16* __restrict__ kw,
    __nv_bfloat16* __restrict__ out, __nv_bfloat16* __restrict__ k_out,
    __nv_bfloat16* __restrict__ v_out, int Hkv, int ps, int maxp, float scale, float eps) {
  const int h = blockIdx.x, bb = blockIdx.y;
  const PageRows<D> rows{bt + (size_t)bb * maxp, ps, Hkv, h};
  fused_step<D, NREP>(qkv, kp, vp, rows, offsets[bb], maxp * ps, cs, sn, qw, kw, out, k_out,
                      v_out, h, bb, Hkv, scale, eps);
}

#define TLT_BF(p) static_cast<const __nv_bfloat16*>(p)
#define TLT_BFW(p) static_cast<__nv_bfloat16*>(p)
#define TLT_F(p) static_cast<const float*>(p)

template <int D, int NREP>
int launch(const void* qkv, const void* keys, const void* values, const void* offsets,
           const void* cs, const void* sn, const void* qw, const void* kw, void* out,
           void* k_out, void* v_out, int layer, int B, int Hkv, int S, float scale,
           float eps, cudaStream_t st) {
  fused_decode_step<D, NREP><<<dim3(Hkv, B), dim3(WARPS * 32), 0, st>>>(
      TLT_BF(qkv), TLT_BF(keys), TLT_BF(values), static_cast<const int*>(offsets), TLT_F(cs),
      TLT_F(sn), TLT_BF(qw), TLT_BF(kw), TLT_BFW(out), TLT_BFW(k_out), TLT_BFW(v_out), layer,
      B, Hkv, S, scale, eps);
  return (int)cudaGetLastError();
}

template <int D, int NREP>
int launch_paged(const void* qkv, const void* kp, const void* vp, const void* bt,
                 const void* offsets, const void* cs, const void* sn, const void* qw,
                 const void* kw, void* out, void* k_out, void* v_out, int B, int Hkv, int ps,
                 int maxp, float scale, float eps, cudaStream_t st) {
  fused_paged_step<D, NREP><<<dim3(Hkv, B), dim3(WARPS * 32), 0, st>>>(
      TLT_BF(qkv), TLT_BF(kp), TLT_BF(vp), static_cast<const int*>(bt),
      static_cast<const int*>(offsets), TLT_F(cs), TLT_F(sn), TLT_BF(qw), TLT_BF(kw),
      TLT_BFW(out), TLT_BFW(k_out), TLT_BFW(v_out), Hkv, ps, maxp, scale, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tlt_fused_decode_attention(const void* qkv, const void* keys, const void* values,
                                          const void* offsets, const void* cs, const void* sn,
                                          const void* qw, const void* kw, void* out, void* k_out,
                                          void* v_out, int layer, int B, int Hkv, int S, int D,
                                          int n_rep, float scale, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TLT_K2(DD, RR)                                                                     \
  if (D == DD && n_rep == RR)                                                              \
    return launch<DD, RR>(qkv, keys, values, offsets, cs, sn, qw, kw, out, k_out, v_out, \
                          layer, B, Hkv, S, scale, eps, st);
  TLT_K2(64, 1) TLT_K2(64, 2) TLT_K2(64, 4) TLT_K2(64, 8)
  TLT_K2(128, 1) TLT_K2(128, 2) TLT_K2(128, 4) TLT_K2(128, 8)
#undef TLT_K2
  return (int)cudaErrorInvalidValue;
}

extern "C" int tlt_fused_paged_decode_attention(
    const void* qkv, const void* kp, const void* vp, const void* bt, const void* offsets,
    const void* cs, const void* sn, const void* qw, const void* kw, void* out, void* k_out,
    void* v_out, int B, int Hkv, int ps, int maxp, int D, int n_rep, float scale, float eps,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TLT_KP(DD, RR)                                                                   \
  if (D == DD && n_rep == RR)                                                            \
    return launch_paged<DD, RR>(qkv, kp, vp, bt, offsets, cs, sn, qw, kw, out, k_out,   \
                                v_out, B, Hkv, ps, maxp, scale, eps, st);
  TLT_KP(64, 1) TLT_KP(64, 2) TLT_KP(64, 4) TLT_KP(64, 8)
  TLT_KP(128, 1) TLT_KP(128, 2) TLT_KP(128, 4) TLT_KP(128, 8)
#undef TLT_KP
  return (int)cudaErrorInvalidValue;
}

// The prep kernel (tlt_fused_qkv_prep), after K2 and its twin so that their
// machine code is what it was.
namespace {

template <int D, int NREP>
__global__ void __launch_bounds__(WARPS * 32) qkv_prep(
    const __nv_bfloat16* __restrict__ qkv,  // [B, Hkv, NREP + 2, D]
    const float* __restrict__ cos_row, const float* __restrict__ sin_row,  // [B, D/2]
    const __nv_bfloat16* __restrict__ qw, const __nv_bfloat16* __restrict__ kw,  // [D]
    __nv_bfloat16* __restrict__ q_out,  // [B, Hkv, NREP, D]
    __nv_bfloat16* __restrict__ k_out,  // [B, Hkv, D]
    __nv_bfloat16* __restrict__ v_out,  // [B, Hkv, D]
    int Hkv, float eps) {
  constexpr int HALF = D / 2, DPL = D / 32;
  __shared__ float xrow[NREP + 1][D];  // normed rows before RoPE
  const int h = blockIdx.x, bb = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t head = (size_t)bb * Hkv + h;
  const __nv_bfloat16* row = qkv + head * (NREP + 2) * D;
  const float* cs = cos_row + (size_t)bb * HALF;
  const float* sn = sin_row + (size_t)bb * HALF;

  // QK-RMSNorm: warp r normalizes row r (q rows 0..NREP-1, k row NREP).
  for (int r = warp; r <= NREP; r += WARPS) {
    const __nv_bfloat16* wt = r < NREP ? qw : kw;
    float x[DPL];
    float ss = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      x[e] = bf2f(row[r * D + lane + 32 * e]);
      ss += x[e] * x[e];
    }
    const float inv = rsqrtf(warp_sum(ss) / D + eps);
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const float normed = round_bf16(__fmul_rn(x[e], inv));
      xrow[r][lane + 32 * e] = round_bf16(__fmul_rn(normed, bf2f(wt[lane + 32 * e])));
    }
  }
  if (tid < D) v_out[head * D + tid] = row[(NREP + 1) * D + tid];
  __syncthreads();
  // RoPE: f32 rotate, bf16 round; q left unscaled.
  for (int idx = tid; idx < (NREP + 1) * HALF; idx += blockDim.x) {
    const int r = idx / HALF, i = idx % HALF;
    const float x1 = xrow[r][i], x2 = xrow[r][i + HALF];
    const float c = cs[i], sv = sn[i];
    const __nv_bfloat16 re = __float2bfloat16_rn(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, sv)));
    const __nv_bfloat16 im = __float2bfloat16_rn(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, sv)));
    __nv_bfloat16* o = r < NREP ? q_out + (head * NREP + r) * D : k_out + head * D;
    o[i] = re;
    o[i + HALF] = im;
  }
}

template <int D, int NREP>
int launch_prep(const void* qkv, const void* cs, const void* sn, const void* qw, const void* kw,
                void* q_out, void* k_out, void* v_out, int B, int Hkv, float eps,
                cudaStream_t st) {
  qkv_prep<D, NREP><<<dim3(Hkv, B), dim3(WARPS * 32), 0, st>>>(
      TLT_BF(qkv), TLT_F(cs), TLT_F(sn), TLT_BF(qw), TLT_BF(kw), TLT_BFW(q_out), TLT_BFW(k_out),
      TLT_BFW(v_out), Hkv, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tlt_fused_qkv_prep(const void* qkv, const void* cs, const void* sn,
                                  const void* qw, const void* kw, void* q_out, void* k_out,
                                  void* v_out, int B, int Hkv, int D, int n_rep, float eps,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TLT_QP(DD, RR)  \
  if (D == DD && n_rep == RR) \
    return launch_prep<DD, RR>(qkv, cs, sn, qw, kw, q_out, k_out, v_out, B, Hkv, eps, st);
  TLT_QP(64, 1) TLT_QP(64, 2) TLT_QP(64, 4) TLT_QP(64, 8)
  TLT_QP(128, 1) TLT_QP(128, 2) TLT_QP(128, 4) TLT_QP(128, 8)
#undef TLT_QP
  return (int)cudaErrorInvalidValue;
}
