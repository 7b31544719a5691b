// The split-key decode walk shared by the paged kernels (paged_attention.cu:
// rows 10-12's paged decode over the whole pool, row 14's walk over one
// shard's pages), the shard decode state over a dense slab
// (flash_attention.cu, row 6) and the fused paged decode step
// (fused_decode_attention.cu, row 9: its q rows from its own prologue), and
// its combine.
//
// The walk (row 5's decode walk over the keys a Keys functor addresses,
// below): a block per (split, KV head, batch row) holds all n_rep x L rows
// of the KV head (16 * MT, MT m16 tiles); the split's keys, in tiles of 64
// through a three-stage cp.async ring (K, V and each key's position; rows
// at or past the length zero-filled and never read); both products as
// mma.sync m16n8k16 (bf16, f32 sums), K and V read by ldmatrix from
// XOR-swizzled rows; KW warps split a tile's keys when the rows are few,
// their states merged in shared memory. A key is masked where its position
// passes the row's (lens - L + i): that covers the length too. Each block
// writes an f32 partial (acc, m, l) per row; state_combine merges a row's
// partials (those of the splits below its length, the sums only where the
// split saw a key) in f32 and writes o = acc / max(l, 1e-30) rounded to
// bf16 once, m and l; a row that saw no key is exactly (0, NEG_INF, 0).
// Rounding points are the TPU kernels' (_flash_inner): q * scale rounds to
// bf16, scores and the state are f32, p rounds to bf16 for the PV product
// (against the running max of its split's walk, per warp).
#pragma once

#include <climits>

#include "flash_mma.cuh"
#include "mma_sync.cuh"

namespace {

constexpr int PDS_STAGES = 3;         // ring stages of the walk
constexpr int PDS_MAX_ENTRIES = 256;  // table entries a split holds at most

// KW warps share a key tile's 64 keys when the rows are few (MT m16 tiles):
// MT * KW warps, at most 8.
__host__ __device__ constexpr int pds_kw(int mt) { return mt >= 8 ? 1 : mt >= 4 ? 2 : 4; }

// A ring stage: K and V of 64 keys, then each key's global position.
template <int D>
__host__ __device__ constexpr int pds_stage_bytes() { return 2 * fmma::BN * D * 2 + fmma::BN * 4; }

// q rows, the ring, then the split's list (local page ids and entries).
template <int D, int MT>
__host__ __device__ constexpr int pds_smem_bytes() {
  return 16 * MT * D * 2 + PDS_STAGES * pds_stage_bytes<D>() + PDS_MAX_ENTRIES * 8;
}

// Where the walk finds the keys of a (batch row, KV head). A split is the
// key range [e0, e0 + per) of the row below its length, except with LIST,
// where it is `per` table entries of which the block lists the shard's own.
//  * PoolKeys (rows 10-12, the paged decode over the whole pool): every
//    table entry is the row's own page as it stands (-1 reads the trash
//    page 0), so a split may start and end inside a page. A page holds hp
//    KV heads (the pool's; a head shard's first head at the base pointer).
//  * ShardPages (row 14, LIST): the entries in [base, base + p_loc), the
//    shard's pages of a page-striped pool.
//  * SlabKeys (row 6): one shard of a dense slab, a strided view: key p of
//    (bb, h) at bb * sb + h * sh + p * D.
template <int D>
struct PoolKeys {
  static constexpr bool LIST = false;
  const int* bt;  // [B, maxp] global ids, -1 padded
  int maxp, ps, hp;  // hp: the KV heads a page holds
  __device__ __forceinline__ int limit() const { return maxp * ps; }
  __device__ __forceinline__ size_t operator()(int p, int bb, int h) const {
    const int j = p / ps, off = p - j * ps;
    const int page = max(__ldg(bt + (size_t)bb * maxp + j), 0);  // -1 -> trash page 0
    return (((size_t)page * hp + h) * ps + off) * D;
  }
};

struct ShardPages {
  static constexpr bool LIST = true;
  const int* bt;  // [B, maxp] global ids, -1 padded
  int maxp, ps, base, p_loc;
};

template <int D>
struct SlabKeys {
  static constexpr bool LIST = false;
  long long sb, sh;  // batch and head strides, elements
  int S;             // the shard's keys
  __device__ __forceinline__ int limit() const { return S; }
  __device__ __forceinline__ size_t operator()(int p, int bb, int h) const {
    return (size_t)bb * sb + (size_t)h * sh + (size_t)p * D;
  }
};

// Where the walk's q rows come from: by cp.async from q (QGlobal), or, with
// SMEM, written by the functor itself (raw bf16 in rswz<D> rows at the
// start of the dynamic shared memory, padding rows zeros; q is not read):
// row 9's fused step computes them (its prologue), called by every thread
// once the split's first key tiles are in flight.
struct QGlobal {
  static constexpr bool SMEM = false;
  __device__ __forceinline__ void operator()() const {}
};

// The split walk's body: block (split, h, bb) writes the f32 partial (the
// sum of p v, m and l) of each of the KV head's n_rep x L rows over its
// split's keys, which state_combine or decode_combine merge. A split past
// the row's keys returns at once, before calling qfill.
template <int D, int MT, class Keys, class QFill = QGlobal>
__device__ __forceinline__ void state_walk(
    const __nv_bfloat16* __restrict__ q,   // [B, Hq, L, D]
    const __nv_bfloat16* __restrict__ kp,  // the keys' base: the pool, the shard's pages or the slab
    const __nv_bfloat16* __restrict__ vp,
    const Keys keys,
    const int* __restrict__ lens,  // [B] context lengths (SlabKeys: the shard's keys)
    float* __restrict__ ws_o,      // [splits, B, Hq, L, D] f32: each split's sum of p v
    float* __restrict__ ws_ml,     // [splits, B, Hq, L, 2] f32: its m and l
    int Hkv, int n_rep, int L, int per, float scale, const QFill& qfill = QFill{}) {
  using fmma::BN;
  using fmma::LOG2E;
  constexpr int KW = pds_kw(MT), NW = MT * KW, THREADS = 32 * NW;
  constexpr int RP = 16 * MT;                                // block rows, padded
  constexpr int KPW = BN / KW, NJ = KPW / 8, KS = KPW / 16;  // a warp's keys of a tile
  constexpr int CH = D / 8, KVB = BN * D * 2, STG = pds_stage_bytes<D>();
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int n_own;
  const uint32_t qs = fmma::smem_u32(smem), ring = qs + RP * D * 2;
  int* own_loc = reinterpret_cast<int*>(smem + RP * D * 2 + PDS_STAGES * STG);
  int* own_ent = own_loc + PDS_MAX_ENTRIES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int split = blockIdx.x, h = blockIdx.y, bb = blockIdx.z, B = gridDim.z;
  const int Hq = Hkv * n_rep, R = n_rep * L;
  const int kend = lens[bb], e0 = split * per;
  // Past the row's keys: the combine reads nothing here.
  int e1;
  if constexpr (Keys::LIST) {
    if ((long long)e0 * keys.ps >= kend) return;
    e1 = min(min(e0 + per, keys.maxp), (kend + keys.ps - 1) / keys.ps);
  } else {
    if ((long long)e0 >= kend) return;
    e1 = min(min(e0 + per, keys.limit()), kend);
  }

  // The block's q rows, raw, into shared memory (padding rows zeros): in
  // flight while warp 0 lists the split's pages. Scaled when the fragments
  // are built.
  if constexpr (!QFill::SMEM) {
    for (int idx = tid; idx < RP * CH; idx += THREADS) {
      const int rr = idx / CH, c = idx % CH;
      const bool ok = rr < R;
      const size_t o = ok ? (((size_t)bb * Hq + h * n_rep + rr / L) * L + rr % L) * D + c * 8 : 0;
      fmma::cp_async16(qs + rswz<D>(rr, c), q + o, ok ? 16 : 0);
    }
  }
  fmma::cp_async_commit();
  if constexpr (Keys::LIST) {
    if (warp == 0) {
      int n = 0;
      for (int c0 = e0; c0 < e1; c0 += 32) {
        const int e = c0 + lane;
        const int loc = e < e1 ? __ldg(keys.bt + (size_t)bb * keys.maxp + e) - keys.base : -1;
        const bool mine = (unsigned)loc < (unsigned)keys.p_loc;  // -1 entries, other shards': no
        const unsigned bal = __ballot_sync(0xffffffffu, mine);
        if (mine) {
          const int at = n + __popc(bal & ((1u << lane) - 1));
          own_loc[at] = loc;
          own_ent[at] = e;
        }
        n += __popc(bal);
      }
      if (lane == 0) n_own = n;
    }
    __syncthreads();
  }
  int nk;
  if constexpr (Keys::LIST) {
    nk = n_own * keys.ps;
  } else {
    nk = e1 - e0;
  }
  const int nt = (nk + BN - 1) / BN;
  if (Keys::LIST && nt == 0) {  // none of the shard's pages: the identity's m and l
    for (int rr = tid; rr < R; rr += THREADS) {
      const size_t row = (((size_t)split * B + bb) * Hq + h * n_rep + rr / L) * L + rr % L;
      ws_ml[2 * row] = TLT_NEG_INF;
      ws_ml[2 * row + 1] = 0.f;
    }
    fmma::cp_async_wait<0>();
    return;
  }

  // Tile t of the split's keys (LIST: of the list's) into its ring stage:
  // K, V and each key's position (INT_MAX at or past the length, or past
  // the list).
  auto load = [&](int t) {
    const uint32_t st = ring + (t % PDS_STAGES) * STG;
    int* kpos = reinterpret_cast<int*>(smem + (st - qs) + 2 * KVB);
    for (int idx = tid; idx < BN * CH; idx += THREADS) {
      const int r = idx / CH, c = idx % CH, kc = t * BN + r;
      int pos = INT_MAX;
      size_t o = 0;
      if constexpr (!Keys::LIST) {
        if (kc < nk) {
          const int p = e0 + kc;
          pos = p;
          o = keys(p, bb, h) + c * 8;
        }
      } else if (kc < nk) {
        const int ps = keys.ps, j = kc / ps, off = kc - j * ps;
        const int p = own_ent[j] * ps + off;
        if (p < kend) {
          pos = p;
          o = (((size_t)own_loc[j] * Hkv + h) * ps + off) * D + c * 8;
        }
      }
      fmma::cp_async16(st + rswz<D>(r, c), kp + o, pos != INT_MAX ? 16 : 0);
      fmma::cp_async16(st + KVB + rswz<D>(r, c), vp + o, pos != INT_MAX ? 16 : 0);
      if (c == 0) kpos[r] = pos;
    }
  };
#pragma unroll
  for (int i = 0; i < PDS_STAGES - 1; ++i) {
    if (i < nt) load(i);
    fmma::cp_async_commit();
  }
  if constexpr (QFill::SMEM) qfill();

  fmma::cp_async_wait<PDS_STAGES - 1>();
  __syncthreads();  // q landed

  // This warp: m16 tile mt of the rows, keys kw * KPW .. of every tile; its
  // q fragments, q * scale rounded to bf16, and its rows' last visible
  // positions (lens - L + i).
  const int mt = warp / KW, kw = warp % KW, kc = kw * KPW;
  const bool busy = 16 * mt < R;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    ldsm_x4(qf[ks],
            qs + rswz<D>(16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1), 2 * ks + (lane >> 4)));
#pragma unroll
    for (int e = 0; e < 4; ++e)
      qf[ks][e] = fmma::pack_bf16(lo_bf16(qf[ks][e]) * scale, hi_bf16(qf[ks][e]) * scale);
  }
  int qlim[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) qlim[hh] = kend - L + (16 * mt + g + 8 * hh) % L;
  float m[2] = {TLT_NEG_INF, TLT_NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int t = 0; t < nt; ++t) {
    fmma::cp_async_wait<PDS_STAGES - 2>();
    __syncthreads();  // tile t landed; tile t - 1's stage is free
    if (t + PDS_STAGES - 1 < nt) load(t + PDS_STAGES - 1);
    fmma::cp_async_commit();
    if (!busy) continue;
    const uint32_t st = ring + (t % PDS_STAGES) * STG;
    const int* kpos = reinterpret_cast<const int*>(smem + (st - qs) + 2 * KVB);
    // Scores of the warp's keys.
    float sc[4 * NJ];
#pragma unroll
    for (int e = 0; e < 4 * NJ; ++e) sc[e] = 0.f;
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int ks = 0; ks < D / 16; ks += 2) {
        uint32_t b[4];
        ldsm_x4(b, st + rswz<D>(kc + 8 * nj + (lane & 7), 2 * ks + (lane >> 3)));
        mma16816(sc + 4 * nj, qf[ks], b[0], b[1]);
        mma16816(sc + 4 * nj, qf[ks + 1], b[2], b[3]);
      }
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) {
      const int2 kp2 = *reinterpret_cast<const int2*>(kpos + kc + 8 * nj + 2 * tig);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if ((e & 1 ? kp2.y : kp2.x) > qlim[e >> 1]) sc[4 * nj + e] = TLT_NEG_INF;
    }
    // Online softmax (rows g and g + 8; a row's keys span the quad).
    float alpha[2], mf[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = m[hh];
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
        mx = fmaxf(mx, fmaxf(sc[4 * nj + 2 * hh], sc[4 * nj + 2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[hh] = fmma::ex2((m[hh] - mx) * LOG2E);
      mf[hh] = fmaxf(mx, TLT_NEG_INF / 2);
      m[hh] = mx;
    }
    uint32_t pa[KS][4];  // P as bf16 A fragments, 16 keys each
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = fmma::ex2((sc[4 * nj + e] - mf[e >> 1]) * LOG2E);
        rs[e >> 1] += p[e];
      }
      pa[nj >> 1][(nj & 1) * 2 + 0] = fmma::pack_bf16(p[0], p[1]);
      pa[nj >> 1][(nj & 1) * 2 + 1] = fmma::pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + rs[hh];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] *= alpha[e >> 1];
    // O += P V.
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int dn = 0; dn < D / 8; dn += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, st + KVB + rswz<D>(kc + 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1),
                                        dn + (lane >> 4)));
        mma16816(acc[dn], pa[kk], b[0], b[1]);
        mma16816(acc[dn + 1], pa[kk], b[2], b[3]);
      }
  }

  // Merge the KW warps' states of each m16 tile in shared memory (the ring
  // is free), and write the split's partial of every row below R.
  fmma::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + RP * D * 2);  // [NW][16][D]
  float* red_m = red + NW * 16 * D;                           // [NW][16]
  float* red_l = red_m + NW * 16;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int r16 = g + 8 * hh;
    float* o = red + (warp * 16 + r16) * D + 2 * tig;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<float2*>(o + 8 * dn) = make_float2(acc[dn][2 * hh], acc[dn][2 * hh + 1]);
    if (tig == 0) {
      red_m[warp * 16 + r16] = m[hh];
      red_l[warp * 16 + r16] = l[hh];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < R * D; idx += THREADS) {
    const int rr = idx / D, d = idx % D, w0 = (rr / 16) * KW, r16 = rr % 16;
    float mx = TLT_NEG_INF;
#pragma unroll
    for (int w = 0; w < KW; ++w) mx = fmaxf(mx, red_m[(w0 + w) * 16 + r16]);
    const float mfl = fmaxf(mx, TLT_NEG_INF / 2);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const float f = fmma::ex2((red_m[(w0 + w) * 16 + r16] - mfl) * LOG2E);
      a += f * red[((w0 + w) * 16 + r16) * D + d];
      ls += f * red_l[(w0 + w) * 16 + r16];
    }
    const size_t row = (((size_t)split * B + bb) * Hq + h * n_rep + rr / L) * L + rr % L;
    ws_o[row * D + d] = a;
    if (d == 0) {
      ws_ml[2 * row] = mx;
      ws_ml[2 * row + 1] = ls;
    }
  }
}

// One warp a row of the state: the partials of the splits that may hold
// the row's keys, weighted by exp(m_s - max m) in f32 (a split that saw no
// key of the row, m_s = NEG_INF, adds nothing and its sums are not read);
// o = sum / max(l, 1e-30) rounded once and, STATE, m = max m_s and l = the
// weighted sum of l_s.
template <int D, bool STATE>
__device__ __forceinline__ void combine_rows(
    const float* __restrict__ ws_o, const float* __restrict__ ws_ml,
    const int* __restrict__ lens, __nv_bfloat16* __restrict__ out, float* __restrict__ m_out,
    float* __restrict__ l_out, int B, int Hq, int L, int keys_per_split, int splits) {
  constexpr int E = D / 32;
  const int rows = B * Hq * L;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int kend = __ldg(lens + row / (Hq * L));
  // STATE: the splits below the row's length. Otherwise those that hold a
  // key at or before the row's position (lens - L + i): a split past it
  // saw no key of the row, or (the prefill's key split) wrote nothing.
  const int pos = kend - L + row % L;
  const int n = STATE ? (kend > 0 ? min(splits, (kend + keys_per_split - 1) / keys_per_split) : 0)
                      : (pos >= 0 ? min(splits, pos / keys_per_split + 1) : 0);
  float mx = TLT_NEG_INF;
#pragma unroll 8
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, __ldg(ws_ml + 2 * ((size_t)s * rows + row)));
  const float mfl = fmaxf(mx, TLT_NEG_INF / 2);
  float a[E] = {}, ls = 0.f;
#pragma unroll 8
  for (int s = 0; s < n; ++s) {
    const size_t r = (size_t)s * rows + row;
    const float ms = __ldg(ws_ml + 2 * r);
    if (ms <= TLT_NEG_INF) continue;
    const float w = expf(ms - mfl);
    ls += w * __ldg(ws_ml + 2 * r + 1);
#pragma unroll
    for (int e = 0; e < E; ++e) a[e] += w * __ldg(ws_o + r * D + lane * E + e);
  }
  const float inv = 1.f / fmaxf(ls, 1e-30f);
  __nv_bfloat16* o = out + (size_t)row * D + lane * E;
#pragma unroll
  for (int e = 0; e < E; ++e) o[e] = __float2bfloat16_rn(a[e] * inv);
  if (STATE && lane == 0) {
    m_out[row] = mx;
    l_out[row] = ls;
  }
}

template <int D>
__global__ void __launch_bounds__(256) state_combine(
    const float* __restrict__ ws_o, const float* __restrict__ ws_ml,
    const int* __restrict__ lens, __nv_bfloat16* __restrict__ out, float* __restrict__ m_out,
    float* __restrict__ l_out, int B, int Hq, int L, int keys_per_split, int splits) {
  combine_rows<D, true>(ws_o, ws_ml, lens, out, m_out, l_out, B, Hq, L, keys_per_split, splits);
}

// The walk's workspace, in bytes, for `splits` splits of B x Hkv x n_rep x
// L rows: the partials ws_o then ws_ml, each part 256-aligned.
struct StateWorkspace {
  size_t o, ml;
};
StateWorkspace state_workspace(int splits, int B, int Hkv, int L, int D, int n_rep) {
  auto up = [](size_t x) { return (x + 255) / 256 * 256; };
  const size_t rows = (size_t)splits * B * Hkv * n_rep * L;
  return {up(rows * D * 4), up(rows * 2 * 4)};
}

}  // namespace
