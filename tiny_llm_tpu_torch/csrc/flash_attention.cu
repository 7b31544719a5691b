// K3: causal flash attention over dense K/V with a per-row length clamp,
// for Hopper (sm_90a).
//
// Replaces tiny_llm_tpu/kernels/flash_attention_pallas.py::_prefill_kernel
// (through _flash_prefill / flash_attention_pallas for L > 16), and covers
// its L <= 16 sibling _decode_kernel (_flash_decode) too: this kernel takes
// any L >= 1. Query i of row b sits at position lens[b] - L + i and sees
// keys at positions <= its own. A row that sees no key emits 0, not NaN
// (NEG_INF = -1e30 with the NEG_INF/2 floor on the subtrahend).
//
// Rounding points follow the TPU kernel: q * scale rounds to bf16, scores
// and the softmax state are f32, probabilities round to bf16 for the PV
// product, the output is acc / max(l, 1e-30) rounded to bf16.
//
// Bound on the H100: at the prefill shapes (L = 128, context 128) the
// q/k/v/out bytes and the 4*L*S*D*Hq operations are both small; the
// kernel is bounded by its own SIMT arithmetic and the launch.
//
// Design: one block per (q tile, kv head, batch row), 8 warps, 64 query
// rows per block = the kv head's n_rep query heads times 64/n_rep
// positions, so each K/V tile loaded into shared memory serves every
// query head that shares it. Key tiles of 32 positions: each lane scores
// one key for the warp's 8 rows (K rows padded in shared memory so lanes
// hit distinct banks), the warp updates the 8 rows' online-softmax states,
// and the PV product runs with each lane owning D/32 output dims. Tiles
// past the q tile's last visible key are never loaded. SIMT only; tensor
// cores are a later step.
#include "common.cuh"

namespace {

constexpr int WARPS = 8, ROWS = 64, RPW = ROWS / WARPS, KT = 32;

template <int D, int NREP>
__global__ void __launch_bounds__(WARPS * 32) flash_prefill(
    const __nv_bfloat16* __restrict__ q,  // [B, Hq, L, D]
    const __nv_bfloat16* __restrict__ k,  // [B, Hkv, S, D]
    const __nv_bfloat16* __restrict__ v,
    const int* __restrict__ lens,  // [B]
    __nv_bfloat16* __restrict__ out,  // [B, Hq, L, D]
    int Hkv, int L, int S, float scale) {
  constexpr int BQ = ROWS / NREP, DPL = D / 32, KW = D / 2 + 1;  // padded K row, words
  __shared__ __align__(16) __nv_bfloat16 Qs[ROWS][D];
  __shared__ uint32_t Ks[KT][KW];
  __shared__ __align__(16) __nv_bfloat16 Vs[KT][D];
  __shared__ float Ps[WARPS][RPW][KT];

  const int qt = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * NREP;
  const int len = lens[bb];
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
  // Keys visible to the tile's last row (clamped to the row's length).
  const int kmax = min(len, len - L + min(q0 + BQ, L));
  const size_t kv_base = ((size_t)bb * Hkv + h) * (size_t)S * D;

  for (int t0 = 0; t0 < kmax; t0 += KT) {
    __syncthreads();  // previous tile consumed (and Qs written)
    for (int idx = tid; idx < KT * D / 8; idx += blockDim.x) {
      const int j = idx / (D / 8), c = idx % (D / 8);
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (t0 + j < S) {
        kv4 = __ldg(reinterpret_cast<const uint4*>(k + kv_base + (size_t)(t0 + j) * D) + c);
        vv4 = __ldg(reinterpret_cast<const uint4*>(v + kv_base + (size_t)(t0 + j) * D) + c);
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
      const float s_i = kpos <= qpos[i] ? sc[i] : TLT_NEG_INF;
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

template <int D, int NREP>
int launch(const void* q, const void* k, const void* v, const void* lens, void* out, int B,
           int Hkv, int L, int S, float scale, cudaStream_t st) {
  constexpr int BQ = ROWS / NREP;
  flash_prefill<D, NREP><<<dim3((L + BQ - 1) / BQ, Hkv, B), dim3(WARPS * 32), 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(out), Hkv, L, S, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tlt_flash_attention(const void* q, const void* k, const void* v, const void* lens,
                                   void* out, int B, int Hkv, int L, int S, int D, int n_rep,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TLT_K3(DD, RR) \
  if (D == DD && n_rep == RR) return launch<DD, RR>(q, k, v, lens, out, B, Hkv, L, S, scale, st);
  TLT_K3(64, 1) TLT_K3(64, 2) TLT_K3(64, 4) TLT_K3(64, 8)
  TLT_K3(128, 1) TLT_K3(128, 2) TLT_K3(128, 4) TLT_K3(128, 8)
#undef TLT_K3
  return (int)cudaErrorInvalidValue;
}
