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
// Both run one body, fused_walk below. A walk of one block per (b, kv
// head), scoring each key against every q row on SIMT lanes and taking the
// PV product a key at a time, lost 2-6x to SDPA: 8 to 32 blocks on 132 SMs
// at 4B's heads, each walking its row's context serially. Instead, the
// split-key walk of split_walk.cuh (rows 6 and 10-14's) in one launch:
//   * grid (splits, Hkv, B), splits of `kps` keys from the shapes alone
//     (kernels/paged_attention.py decode_split, with the slab's S or the
//     table's width), never from the offsets or the table, which live on
//     the device;
//   * every block redoes the step's prologue for its (b, h) (norm and RoPE
//     of n_rep + 1 rows) while its first key tiles are in flight, and writes
//     its q rows into the walk's q tile (the walk's QFill); split 0 writes
//     k_out and v_out;
//   * state_walk over the split's keys below off, through SlabKeys (one
//     layer's [B, Hkv, S, D] slab: fused_dense_walk) or PoolKeys (-1 entries
//     read the trash page 0: fused_paged_walk); nothing at or past off is
//     read; both products on mma.sync m16n8k16, an f32 partial (acc, m, l)
//     per row;
//   * each block then arrives at a counter per (b, h) (__threadfence, then
//     atomicAdd; a split with no key arrives too); the last to arrive merges
//     the partials (combine_rows' arithmetic, read through L2), folds the
//     current token in and writes out, and resets the counter to 0 for the
//     next launch. At off = 0 every split is empty and out is the v row
//     exactly.
// The q rows are bf16(q * scale) in the walk's fragments; p rounds to bf16
// against its warp's running max.
//
// tlt_fused_qkv_prep replaces
// tiny_llm_tpu/kernels/fused_decode_attention.py::_qkv_prep_kernel (through
// fused_qkv_prep): the step's prologue alone, for the three-launch paged
// decode (prep, then the paged decode kernel reads the pages with the
// current token already in them). It returns q normed and roped but NOT
// scaled (the fused step keeps q pre-scaled; the attention kernel scales
// it) at the step's rounding points, and writes the normed and roped k row
// and the raw v row into the layer's page pools at each row's (page, slot)
// (given on the device: no host sync), or, without pools, returns them.
// Bound on the H100: it moves B * Hkv * (2 * n_rep + 4) * D * 2 bytes (36
// KB at Qwen3-4B's heads and B = 4), 0.01 us at 3.35 TB/s; the launch
// bounds it, so writing the pages here, not in scatter launches of their
// own, is where time is saved. Grid (row blocks, Hkv, B), D / 8 lanes a
// row: 16-byte loads and stores, the sum of squares by shuffles within the
// row's lanes, RoPE's pairs (i, i + D / 2) by one shuffle across them, all
// in registers.
#include "split_walk.cuh"

#define TLT_BF(p) static_cast<const __nv_bfloat16*>(p)
#define TLT_BFW(p) static_cast<__nv_bfloat16*>(p)
#define TLT_F(p) static_cast<const float*>(p)

// K2 and row 9: the fused decode step as a split-key tensor-core walk.
namespace {

// The walk's block for n_rep <= 8 rows, one m16 tile: 4 warps.
constexpr int PW_THREADS = 32 * pds_kw(1);

// Dynamic shared memory: the walk's (q tile, ring), then this kernel's
// normed rows [NREP + 1][D] and the current token's k and v rows, f32.
template <int D, int NREP>
constexpr int paged_walk_smem() {
  return pds_smem_bytes<D, 1>() + (NREP + 3) * D * 4;
}

int paged_walk_splits(int maxp, int ps, int kps) { return (maxp * ps + kps - 1) / kps; }

// The step's prologue for one (b, h), the walk's QFill (split_walk.cuh): QK-RMSNorm
// (warp r on rows r, r + NW, ...: q rows 0..NREP-1, k row NREP), rounded to
// bf16 before and after the weight; RoPE (f32 rotate, bf16 round). The q
// rows go raw into the walk's q tile (the walk takes bf16(q * scale), the
// TPU kernel's pre-scaled q), the k and v rows into kcur and vcur (f32, after the walk's
// shared memory) and, where given, k_out and v_out. Every thread calls it.
template <int D, int NREP>
struct StepPrologue {
  static constexpr bool SMEM = true;
  const __nv_bfloat16* row;  // the (b, h)'s qkv rows [NREP + 2, D]
  const float* cs;           // its RoPE rows [D / 2]
  const float* sn;
  const __nv_bfloat16* qw;
  const __nv_bfloat16* kw;
  __nv_bfloat16* k_out;  // the (b, h)'s k_out and v_out rows, or null (splits > 0)
  __nv_bfloat16* v_out;
  uint8_t* smem;  // the dynamic shared memory
  float eps;

  __device__ __forceinline__ void operator()() const {
    constexpr int HALF = D / 2, DPL = D / 32, NW = PW_THREADS / 32, CH = D / 8;
    float* xrow = reinterpret_cast<float*>(smem + pds_smem_bytes<D, 1>());  // [NREP + 1][D]
    float* kcur = xrow + (NREP + 1) * D;
    float* vcur = kcur + D;
    constexpr int ROT = ((NREP + 1) * HALF + PW_THREADS - 1) / PW_THREADS;  // rotations a thread
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float cv[ROT], sv[ROT];  // this thread's RoPE rows, in flight during the norm
#pragma unroll
    for (int k = 0; k < ROT; ++k) {
      const int i = (tid + k * PW_THREADS) % HALF;
      cv[k] = cs[i];
      sv[k] = sn[i];
    }
    for (int r = warp; r <= NREP; r += NW) {
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
        xrow[r * D + lane + 32 * e] = round_bf16(__fmul_rn(normed, bf2f(wt[lane + 32 * e])));
      }
    }
    for (int d = tid; d < D; d += PW_THREADS) {
      const __nv_bfloat16 v = row[(NREP + 1) * D + d];
      vcur[d] = bf2f(v);
      if (v_out != nullptr) v_out[d] = v;
    }
    for (int idx = tid; idx < (16 - NREP) * CH; idx += PW_THREADS)  // the tile's padding rows
      *reinterpret_cast<uint4*>(smem + rswz<D>(NREP + idx / CH, idx % CH)) = make_uint4(0, 0, 0, 0);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ROT; ++k) {
      const int idx = tid + k * PW_THREADS;
      if (idx >= (NREP + 1) * HALF) break;
      const int r = idx / HALF, i = idx % HALF;
      const float x1 = xrow[r * D + i], x2 = xrow[r * D + i + HALF];
      const float c = cv[k], s = sv[k];
      const float re = round_bf16(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
      const float im = round_bf16(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
      if (r < NREP) {
        *q_at(smem, r, i) = __float2bfloat16_rn(re);
        *q_at(smem, r, i + HALF) = __float2bfloat16_rn(im);
      } else {
        kcur[i] = re;
        kcur[i + HALF] = im;
        if (k_out != nullptr) {
          k_out[i] = __float2bfloat16_rn(re);
          k_out[i + HALF] = __float2bfloat16_rn(im);
        }
      }
    }
    __syncthreads();  // the q tile, kcur and vcur are in place
  }

  // Element d of q row r in the walk's q tile (rswz<D> rows of bf16).
  static __device__ __forceinline__ __nv_bfloat16* q_at(uint8_t* smem, int r, int d) {
    return reinterpret_cast<__nv_bfloat16*>(smem + rswz<D>(r, d / 8) + (d % 8) * 2);
  }
};

// The step's body, block (split, h, bb): the split's walk over the keys
// `keys` addresses from kp / vp, its arrival, and the merge where it is the
// last block of its (bb, h).
template <int D, int NREP, class Keys>
__device__ __forceinline__ void fused_walk(
    const __nv_bfloat16* __restrict__ qkv,  // [B, Hkv, NREP + 2, D]
    const __nv_bfloat16* __restrict__ kp,   // the keys' base: the pool or the layer's slab
    const __nv_bfloat16* __restrict__ vp,
    const Keys keys,
    const int* __restrict__ offsets,  // [B]
    const float* __restrict__ cos_row, const float* __restrict__ sin_row,  // [B, D/2]
    const __nv_bfloat16* __restrict__ qw, const __nv_bfloat16* __restrict__ kw,  // [D]
    __nv_bfloat16* __restrict__ out,    // [B, Hkv, NREP, D]
    __nv_bfloat16* __restrict__ k_out,  // [B, Hkv, D]
    __nv_bfloat16* __restrict__ v_out,  // [B, Hkv, D]
    float* __restrict__ ws_o, float* __restrict__ ws_ml,  // the splits' partials
    unsigned* __restrict__ arrivals,  // [B, Hkv]: zero on entry, left zero
    int Hkv, int kps, float scale, float eps) {
  constexpr int DPL = D / 32, NW = PW_THREADS / 32;
  using Prologue = StepPrologue<D, NREP>;
  extern __shared__ __align__(128) uint8_t smem[];
  const float* kcur =  // the prologue's rows after the walk's: [NREP + 1][D] normed, k, v
      reinterpret_cast<const float*>(smem + pds_smem_bytes<D, 1>()) + (NREP + 1) * D;
  const float* vcur = kcur + D;
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, h = blockIdx.y, bb = blockIdx.z, B = gridDim.z;
  const size_t head = (size_t)bb * Hkv + h;
  const Prologue prologue{qkv + head * (NREP + 2) * D, cos_row + (size_t)bb * (D / 2),
                          sin_row + (size_t)bb * (D / 2), qw, kw,
                          split == 0 ? k_out + head * D : nullptr,
                          split == 0 ? v_out + head * D : nullptr, smem, eps};
  const int off = offsets[bb];
  const bool empty = (long long)split * kps >= off;  // state_walk returns at once

  // The split's keys below off, the prologue run once its first key tiles
  // are in flight; an empty split runs it here only if it is split 0 (its
  // k_out and v_out) or, below, the last to arrive.
  state_walk<D, 1, Keys, Prologue>(nullptr, kp, vp, keys, offsets, ws_o, ws_ml, Hkv, NREP, 1,
                                   kps, scale, prologue);
  if (empty && split == 0) prologue();

  // Arrive: the split's partials are written, or it had no key. The last
  // block of this (bb, h) to arrive merges, and resets the count.
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(arrivals + head, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid == 0) arrivals[head] = 0;
  if (empty && split != 0) prologue();

  // combine_rows' arithmetic over the splits below off (each saw a key),
  // the partials read through L2 (the other blocks wrote them), then the
  // current token last: s_cur = bf16(q * scale) . k in f32,
  // its probability rounded to bf16 for the PV sum, the denominator f32.
  // The splits' m and l, then their weights, in the ring (free now).
  const int n = off > 0 ? min((int)gridDim.x, (off + kps - 1) / kps) : 0;
  const size_t rows = (size_t)B * Hkv * NREP;               // a split's partial rows
  const size_t row0 = (size_t)bb * Hkv * NREP + h * NREP;  // this (bb, h)'s first
  float* m_s = reinterpret_cast<float*>(smem + 16 * D * 2);  // [NREP][n]
  float* l_s = m_s + NREP * n;
  float* w_s = l_s + NREP * n;
  __shared__ float mf_r[NREP], ls_r[NREP], sc_r[NREP];
  for (int idx = tid; idx < NREP * n; idx += PW_THREADS) {
    const int r = idx / n, s = idx % n;
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(ws_ml + 2 * (s * rows + row0 + r)));
    m_s[idx] = ml.x;
    l_s[idx] = ml.y;
  }
  __syncthreads();
  for (int r = warp; r < NREP; r += NW) {  // a row's weights exp(m_s - max m), l and s_cur
    float mx = TLT_NEG_INF;
    for (int s = lane; s < n; s += 32) mx = fmaxf(mx, m_s[r * n + s]);
    const float mfl = fmaxf(warp_max(mx), TLT_NEG_INF / 2);
    float ls = 0.f, sc = 0.f;
    for (int s = lane; s < n; s += 32) {
      const float ms = m_s[r * n + s], w = ms > TLT_NEG_INF ? expf(ms - mfl) : 0.f;
      w_s[r * n + s] = w;
      ls += w * l_s[r * n + s];
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane * DPL + e;
      sc += round_bf16(bf2f(*Prologue::q_at(smem, r, d)) * scale) * kcur[d];
    }
    ls = warp_sum(ls);
    sc = warp_sum(sc);
    if (lane == 0) mf_r[r] = mfl, ls_r[r] = ls, sc_r[r] = sc;
  }
  __syncthreads();
  for (int idx = tid; idx < NREP * (D / 4); idx += PW_THREADS) {  // 4 dims of a row each
    const int r = idx / (D / 4), d0 = idx % (D / 4) * 4;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int s = 0; s < n; ++s) {
      const float w = w_s[r * n + s];
      const float4 v =
          __ldcg(reinterpret_cast<const float4*>(ws_o + (s * rows + row0 + r) * D + d0));
      a[0] += w * v.x, a[1] += w * v.y, a[2] += w * v.z, a[3] += w * v.w;
    }
    const float mfl = mf_r[r], s_cur = sc_r[r];
    const float m_new = fmaxf(mfl, s_cur);
    const float alpha = expf(mfl - m_new), pc = expf(s_cur - m_new);
    const float lt = ls_r[r] * alpha + pc, pcb = round_bf16(pc);
    uint32_t o[2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      o[e] = fmma::pack_bf16((a[2 * e] * alpha + pcb * vcur[d0 + 2 * e]) / lt,
                             (a[2 * e + 1] * alpha + pcb * vcur[d0 + 2 * e + 1]) / lt);
    *reinterpret_cast<uint2*>(out + (head * NREP + r) * D + d0) = make_uint2(o[0], o[1]);
  }
}

// Row 9: the pool through the block table (PoolKeys).
template <int D, int NREP>
__global__ void __launch_bounds__(PW_THREADS) fused_paged_walk(
    const __nv_bfloat16* __restrict__ qkv,  // [B, Hkv, NREP + 2, D]
    const __nv_bfloat16* __restrict__ kp,   // [P, Hkv, ps, D]
    const __nv_bfloat16* __restrict__ vp,
    const int* __restrict__ bt,       // [B, maxp], -1 padded
    const int* __restrict__ offsets,  // [B]
    const float* __restrict__ cos_row, const float* __restrict__ sin_row,  // [B, D/2]
    const __nv_bfloat16* __restrict__ qw, const __nv_bfloat16* __restrict__ kw,  // [D]
    __nv_bfloat16* __restrict__ out,    // [B, Hkv, NREP, D]
    __nv_bfloat16* __restrict__ k_out,  // [B, Hkv, D]
    __nv_bfloat16* __restrict__ v_out,  // [B, Hkv, D]
    float* __restrict__ ws_o, float* __restrict__ ws_ml,  // the splits' partials
    unsigned* __restrict__ arrivals,  // [B, Hkv]: zero on entry, left zero
    int Hkv, int ps, int maxp, int kps, float scale, float eps) {
  fused_walk<D, NREP>(qkv, kp, vp, PoolKeys<D>{bt, maxp, ps, Hkv}, offsets, cos_row, sin_row, qw,
                      kw, out, k_out, v_out, ws_o, ws_ml, arrivals, Hkv, kps, scale, eps);
}

// K2: one layer's dense slab (SlabKeys).
template <int D, int NREP>
__global__ void __launch_bounds__(PW_THREADS) fused_dense_walk(
    const __nv_bfloat16* __restrict__ qkv,  // [B, Hkv, NREP + 2, D]
    const __nv_bfloat16* __restrict__ keys,  // the layer's [B, Hkv, S, D]
    const __nv_bfloat16* __restrict__ values,
    const int* __restrict__ offsets,  // [B]
    const float* __restrict__ cos_row, const float* __restrict__ sin_row,  // [B, D/2]
    const __nv_bfloat16* __restrict__ qw, const __nv_bfloat16* __restrict__ kw,  // [D]
    __nv_bfloat16* __restrict__ out,    // [B, Hkv, NREP, D]
    __nv_bfloat16* __restrict__ k_out,  // [B, Hkv, D]
    __nv_bfloat16* __restrict__ v_out,  // [B, Hkv, D]
    float* __restrict__ ws_o, float* __restrict__ ws_ml,  // the splits' partials
    unsigned* __restrict__ arrivals,  // [B, Hkv]: zero on entry, left zero
    int Hkv, int S, int kps, float scale, float eps) {
  fused_walk<D, NREP>(qkv, keys, values, SlabKeys<D>{(long long)Hkv * S * D, (long long)S * D, S},
                      offsets, cos_row, sin_row, qw, kw, out, k_out, v_out, ws_o, ws_ml, arrivals,
                      Hkv, kps, scale, eps);
}

template <int D, int NREP>
int launch_paged_walk(const void* qkv, const void* kp, const void* vp, const void* bt,
                      const void* offsets, const void* cs, const void* sn, const void* qw,
                      const void* kw, void* out, void* k_out, void* v_out, float* ws_o,
                      float* ws_ml, unsigned* arrivals, int B, int Hkv, int ps, int maxp, int kps,
                      float scale, float eps, cudaStream_t st) {
  constexpr int SMEM = paged_walk_smem<D, NREP>();
  static const int attr = (int)cudaFuncSetAttribute(
      fused_paged_walk<D, NREP>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr) return attr;
  fused_paged_walk<D, NREP><<<dim3(paged_walk_splits(maxp, ps, kps), Hkv, B), PW_THREADS, SMEM,
                              st>>>(
      TLT_BF(qkv), TLT_BF(kp), TLT_BF(vp), static_cast<const int*>(bt),
      static_cast<const int*>(offsets), TLT_F(cs), TLT_F(sn), TLT_BF(qw), TLT_BF(kw),
      TLT_BFW(out), TLT_BFW(k_out), TLT_BFW(v_out), ws_o, ws_ml, arrivals, Hkv, ps, maxp, kps,
      scale, eps);
  return (int)cudaGetLastError();
}

template <int D, int NREP>
int launch_dense_walk(const void* qkv, const __nv_bfloat16* keys, const __nv_bfloat16* values,
                      const void* offsets, const void* cs, const void* sn, const void* qw,
                      const void* kw, void* out, void* k_out, void* v_out, float* ws_o,
                      float* ws_ml, unsigned* arrivals, int B, int Hkv, int S, int kps,
                      float scale, float eps, cudaStream_t st) {
  constexpr int SMEM = paged_walk_smem<D, NREP>();
  static const int attr = (int)cudaFuncSetAttribute(
      fused_dense_walk<D, NREP>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr) return attr;
  fused_dense_walk<D, NREP><<<dim3((S + kps - 1) / kps, Hkv, B), PW_THREADS, SMEM, st>>>(
      TLT_BF(qkv), keys, values, static_cast<const int*>(offsets), TLT_F(cs), TLT_F(sn),
      TLT_BF(qw), TLT_BF(kw), TLT_BFW(out), TLT_BFW(k_out), TLT_BFW(v_out), ws_o, ws_ml,
      arrivals, Hkv, S, kps, scale, eps);
  return (int)cudaGetLastError();
}

// The merge keeps 3 floats a (row, split) in the walk's ring.
bool merge_fits(int splits, int n_rep, int D) {
  return (long long)splits * n_rep * 12 <=
         PDS_STAGES * (D == 64 ? pds_stage_bytes<64>() : pds_stage_bytes<128>());
}

}  // namespace

// Bytes of workspace tlt_fused_paged_decode_attention takes for these
// shapes (kps: keys a split, at least 1): the splits' f32 partials.
extern "C" long long tlt_fused_paged_decode_workspace(int B, int Hkv, int maxp, int ps, int D,
                                                      int n_rep, int kps) {
  if (kps < 1) return 0;
  const StateWorkspace w = state_workspace(paged_walk_splits(maxp, ps, kps), B, Hkv, 1, D, n_rep);
  return (long long)(w.o + w.ml);
}

// One launch a call, in splits of `kps` keys. ws: the workspace, at least
// tlt_fused_paged_decode_workspace(...) bytes, 256-byte aligned; arrivals:
// B * Hkv unsigned ints, zero (the kernel leaves them zero).
extern "C" int tlt_fused_paged_decode_attention(
    const void* qkv, const void* kp, const void* vp, const void* bt, const void* offsets,
    const void* cs, const void* sn, const void* qw, const void* kw, void* out, void* k_out,
    void* v_out, void* ws, long long ws_bytes, void* arrivals, int B, int Hkv, int ps, int maxp,
    int D, int n_rep, int kps, float scale, float eps, void* stream) {
  if (kps < 1 || maxp < 1 || ps < 1 || arrivals == nullptr) return (int)cudaErrorInvalidValue;
  const int splits = paged_walk_splits(maxp, ps, kps);
  if (!merge_fits(splits, n_rep, D)) return (int)cudaErrorInvalidValue;
  const StateWorkspace w = state_workspace(splits, B, Hkv, 1, D, n_rep);
  if (ws == nullptr || ws_bytes < (long long)(w.o + w.ml)) return (int)cudaErrorInvalidValue;
  float* ws_o = static_cast<float*>(ws);
  float* ws_ml = reinterpret_cast<float*>(static_cast<uint8_t*>(ws) + w.o);
  unsigned* arr = static_cast<unsigned*>(arrivals);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TLT_KP(DD, RR)                                                                      \
  if (D == DD && n_rep == RR)                                                               \
    return launch_paged_walk<DD, RR>(qkv, kp, vp, bt, offsets, cs, sn, qw, kw, out, k_out, \
                                     v_out, ws_o, ws_ml, arr, B, Hkv, ps, maxp, kps, scale, \
                                     eps, st);
  TLT_KP(64, 1) TLT_KP(64, 2) TLT_KP(64, 4) TLT_KP(64, 8)
  TLT_KP(128, 1) TLT_KP(128, 2) TLT_KP(128, 4) TLT_KP(128, 8)
#undef TLT_KP
  return (int)cudaErrorInvalidValue;
}

// Bytes of workspace tlt_fused_decode_attention takes for these shapes
// (kps: keys a split, at least 1): the splits' f32 partials.
extern "C" long long tlt_fused_decode_workspace(int B, int Hkv, int S, int D, int n_rep, int kps) {
  if (kps < 1) return 0;
  const StateWorkspace w = state_workspace((S + kps - 1) / kps, B, Hkv, 1, D, n_rep);
  return (long long)(w.o + w.ml);
}

// K2: layer `layer` of the slab [layers, B, Hkv, S, D], one launch a call,
// in splits of `kps` keys. ws and arrivals as the paged entry's.
extern "C" int tlt_fused_decode_attention(const void* qkv, const void* keys, const void* values,
                                          const void* offsets, const void* cs, const void* sn,
                                          const void* qw, const void* kw, void* out, void* k_out,
                                          void* v_out, void* ws, long long ws_bytes,
                                          void* arrivals, int layer, int B, int Hkv, int S, int D,
                                          int n_rep, int kps, float scale, float eps,
                                          void* stream) {
  if (kps < 1 || S < 1 || layer < 0 || arrivals == nullptr) return (int)cudaErrorInvalidValue;
  const int splits = (S + kps - 1) / kps;
  if (!merge_fits(splits, n_rep, D)) return (int)cudaErrorInvalidValue;
  const StateWorkspace w = state_workspace(splits, B, Hkv, 1, D, n_rep);
  if (ws == nullptr || ws_bytes < (long long)(w.o + w.ml)) return (int)cudaErrorInvalidValue;
  float* ws_o = static_cast<float*>(ws);
  float* ws_ml = reinterpret_cast<float*>(static_cast<uint8_t*>(ws) + w.o);
  unsigned* arr = static_cast<unsigned*>(arrivals);
  const size_t at = (size_t)layer * B * Hkv * S * D;  // the layer's slab
  const __nv_bfloat16* kk = static_cast<const __nv_bfloat16*>(keys) + at;
  const __nv_bfloat16* vv = static_cast<const __nv_bfloat16*>(values) + at;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TLT_K2(DD, RR)                                                                         \
  if (D == DD && n_rep == RR)                                                                  \
    return launch_dense_walk<DD, RR>(qkv, kk, vv, offsets, cs, sn, qw, kw, out, k_out, v_out, \
                                     ws_o, ws_ml, arr, B, Hkv, S, kps, scale, eps, st);
  TLT_K2(64, 1) TLT_K2(64, 2) TLT_K2(64, 4) TLT_K2(64, 8)
  TLT_K2(128, 1) TLT_K2(128, 2) TLT_K2(128, 4) TLT_K2(128, 8)
#undef TLT_K2
  return (int)cudaErrorInvalidValue;
}

// The prep kernel (tlt_fused_qkv_prep).
namespace {

// Rows of the fused qkv row a block takes (all n_rep + 2 of a (b, kv head)
// when it has fewer). Set by `qmm_crossover --kind prep` (PERF.md): 2, 4
// and every row of a (b, kv head) a block all took 2.16-2.32 us at B = 1
// and 4, both models' heads (the launch's floor); 4 was the least or
// within 2 % of it.
constexpr int PREP_ROWS = 4;

// Grid (row blocks, Hkv, B): D / 8 consecutive lanes a row, 16 bytes a
// lane. WRITE: the k row (normed, roped) and the raw v row go to
// pages[page[b], h, slot[b], :] of the layer's pools (ps slots a page);
// else to k_out and v_out [B, Hkv, D].
template <int D, int NREP, bool WRITE>
__global__ void __launch_bounds__(512) qkv_prep(
    const __nv_bfloat16* __restrict__ qkv,  // [B, Hkv, NREP + 2, D]
    const float* __restrict__ cos_row, const float* __restrict__ sin_row,  // [B, D/2]
    const __nv_bfloat16* __restrict__ qw, const __nv_bfloat16* __restrict__ kw,  // [D]
    __nv_bfloat16* __restrict__ q_out,  // [B, Hkv, NREP, D]
    __nv_bfloat16* __restrict__ k_out,  // [B, Hkv, D], or the layer's key pages [P, Hkv, ps, D]
    __nv_bfloat16* __restrict__ v_out,  // the same for v
    const long long* __restrict__ page, const long long* __restrict__ slot,  // [B] (WRITE)
    int Hkv, int ps, float eps) {
  constexpr int LPR = D / 8, HALF = D / 2, ROWS = NREP + 2;
  constexpr int RPB = ROWS < PREP_ROWS ? ROWS : PREP_ROWS;
  const int h = blockIdx.y, bb = blockIdx.z, l = threadIdx.x % LPR;
  const int r0 = blockIdx.x * RPB + threadIdx.x / LPR;
  const bool live = threadIdx.x / LPR < RPB && r0 < ROWS;
  const int r = live ? r0 : ROWS - 1;  // a lane past the rows computes row ROWS - 1, unstored
  const size_t head = (size_t)bb * Hkv + h;
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(qkv + (head * ROWS + r) * D) + l);
  __nv_bfloat16* dst;
  if (r < NREP) {
    dst = q_out + (head * NREP + r) * D;
  } else {
    __nv_bfloat16* base = r == NREP ? k_out : v_out;
    dst = WRITE ? base + (((size_t)page[bb] * Hkv + h) * ps + slot[bb]) * D : base + head * D;
  }
  if (r == NREP + 1) {  // v: the raw row (its row group's lanes all take this branch)
    if (live) reinterpret_cast<uint4*>(dst)[l] = raw;
    return;
  }
  // QK-RMSNorm: the row's sum of squares over its LPR lanes.
  const uint32_t xw[4] = {raw.x, raw.y, raw.z, raw.w};
  float x[8], ss = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = lo_bf16(xw[i]);
    x[2 * i + 1] = hi_bf16(xw[i]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) ss += x[i] * x[i];
  const unsigned group = ((1u << LPR) - 1) << (threadIdx.x & 31 & ~(LPR - 1));  // the row's lanes
#pragma unroll
  for (int o = 1; o < LPR; o <<= 1) ss += __shfl_xor_sync(group, ss, o);
  const float inv = rsqrtf(ss / D + eps);
  const uint4 wv = __ldg(reinterpret_cast<const uint4*>(r < NREP ? qw : kw) + l);
  const uint32_t ww[4] = {wv.x, wv.y, wv.z, wv.w};
  uint32_t y[4];  // the normed row as bf16 pairs
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = round_bf16(__fmul_rn(round_bf16(__fmul_rn(x[2 * i], inv)), lo_bf16(ww[i])));
    const float c =
        round_bf16(__fmul_rn(round_bf16(__fmul_rn(x[2 * i + 1], inv)), hi_bf16(ww[i])));
    y[i] = fmma::pack_bf16(a, c);
  }
  // RoPE: element i pairs with i + HALF, LPR / 2 lanes on; f32 rotate, bf16
  // round; q left unscaled.
  uint32_t pw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) pw[i] = __shfl_xor_sync(group, y[i], LPR / 2);
  const bool first = l < LPR / 2;  // elements below HALF
  const int at = 2 * (l % (LPR / 2));  // the lane's 8 RoPE columns, as float4s
  const float4* cs4 = reinterpret_cast<const float4*>(cos_row + (size_t)bb * HALF) + at;
  const float4* sn4 = reinterpret_cast<const float4*>(sin_row + (size_t)bb * HALF) + at;
  const float4 c0 = __ldg(cs4), c1 = __ldg(cs4 + 1), s0 = __ldg(sn4), s1 = __ldg(sn4 + 1);
  const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float res[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float own = k ? hi_bf16(y[i]) : lo_bf16(y[i]);
      const float other = k ? hi_bf16(pw[i]) : lo_bf16(pw[i]);
      const float c = cv[2 * i + k], s = sv[2 * i + k];
      // x1 the element below HALF, x2 its partner: x1 c - x2 s below, x2 c + x1 s above.
      res[k] = first ? __fsub_rn(__fmul_rn(own, c), __fmul_rn(other, s))
                     : __fadd_rn(__fmul_rn(own, c), __fmul_rn(other, s));
    }
    o[i] = fmma::pack_bf16(res[0], res[1]);
  }
  if (live) reinterpret_cast<uint4*>(dst)[l] = make_uint4(o[0], o[1], o[2], o[3]);
}

template <int D, int NREP, bool WRITE>
int launch_prep(const void* qkv, const void* cs, const void* sn, const void* qw, const void* kw,
                void* q_out, void* k_out, void* v_out, const void* page, const void* slot, int B,
                int Hkv, int ps, float eps, cudaStream_t st) {
  constexpr int ROWS = NREP + 2, RPB = ROWS < PREP_ROWS ? ROWS : PREP_ROWS;
  constexpr int THREADS = (RPB * (D / 8) + 31) / 32 * 32;
  static_assert(THREADS <= 512, "a block's rows fit its launch bounds");
  qkv_prep<D, NREP, WRITE><<<dim3((ROWS + RPB - 1) / RPB, Hkv, B), dim3(THREADS), 0, st>>>(
      TLT_BF(qkv), TLT_F(cs), TLT_F(sn), TLT_BF(qw), TLT_BF(kw), TLT_BFW(q_out), TLT_BFW(k_out),
      TLT_BFW(v_out), static_cast<const long long*>(page), static_cast<const long long*>(slot),
      Hkv, ps, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// page, slot: int64 [B] on the device, the row's page and slot in the
// layer's pools k_out / v_out [P, Hkv, ps, D] (the k and v rows written
// there); null: k_out and v_out are [B, Hkv, D].
extern "C" int tlt_fused_qkv_prep(const void* qkv, const void* cs, const void* sn,
                                  const void* qw, const void* kw, void* q_out, void* k_out,
                                  void* v_out, const void* page, const void* slot, int B, int Hkv,
                                  int D, int n_rep, int ps, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool write = page != nullptr;
  if (write != (slot != nullptr) || (write && ps < 1)) return (int)cudaErrorInvalidValue;
#define TLT_QP(DD, RR)                                                                       \
  if (D == DD && n_rep == RR)                                                                \
    return write ? launch_prep<DD, RR, true>(qkv, cs, sn, qw, kw, q_out, k_out, v_out, page, \
                                             slot, B, Hkv, ps, eps, st)                      \
                 : launch_prep<DD, RR, false>(qkv, cs, sn, qw, kw, q_out, k_out, v_out,      \
                                              page, slot, B, Hkv, ps, eps, st);
  TLT_QP(64, 1) TLT_QP(64, 2) TLT_QP(64, 4) TLT_QP(64, 8)
  TLT_QP(128, 1) TLT_QP(128, 2) TLT_QP(128, 4) TLT_QP(128, 8)
#undef TLT_QP
  return (int)cudaErrorInvalidValue;
}
