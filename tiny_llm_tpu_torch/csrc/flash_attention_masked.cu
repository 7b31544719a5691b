// Flash attention over dense K/V with an explicit additive mask, for Hopper
// (sm_90a): tlt_flash_attention_masked.
//
// Replaces tiny_llm_tpu/kernels/flash_attention_pallas.py::
// _decode_kernel_masked (L <= 16, through _flash_decode) and
// ::_prefill_kernel_masked (L > 16, through _flash_prefill), both reached
// from flash_attention_pallas(mask=<array>). The mask replaces causality:
// every query row of batch row b sits at position lens[b] - 1, so only the
// length bounds the keys, and the f32 mask value is added to each visible
// key's score after that clamp (sum floored at -1e30). A row that sees no
// key emits 0, not NaN. Mask layouts:
//   mode 1, shared    one [L, S] plane per batch row, every head alike
//                     (a [B, L, S] or [B, 1, L, S] mask; batch stride 0
//                     for an [L, S] mask, which is never materialised);
//   mode 2, per head  one plane per query head ([B, Hq, L, S]);
//   mode 0, none      no mask and no causality (an explicit mask=None:
//                     the lengths alone bound the keys).
// The planes' rows are contiguous (row stride S); msb and msh are the
// batch and head strides in elements.
//
// Bound on the H100: q/k/v/out bytes plus the mask's f32 bytes (4 * L * S
// per plane) over 3.35 TB/s, or 4 * Hq * L * keys * D operations over the
// bf16 peak, counting only the keys the mask leaves visible: a key tile
// that the mask hides from every row of a block need not be read. At
// decode (L <= 16) the K/V and the mask set it; a per-head prefill mask
// (32 planes of 1024 x 1024 at Qwen3-4B's heads: 128 MB) dominates every
// other byte, and a sparse prefill mask (a document mask) is bound by the
// operations of its visible pairs. Two designs behind the one entry:
//
//   L > 16, prefill: flash_mma.cuh's tensor-core tile with its MASK option
//     (warpgroup MMAs for Q K^T and P V, 128-row q tiles of the KV head's
//     n_rep query heads, 64-key tiles, the mask tile in the cp.async ring
//     beside K and V). A first kernel, mask_tile_map, reads every plane
//     once and marks each (plane, 16-row group, 64-key tile) that holds an
//     entry above NEG_INF below L and the row's length; each walk block
//     ORs its groups (and, per head, its n_rep heads) into a list of live
//     tiles and walks only those. Mode 0 has no map: every tile below the
//     length is live.
//
//   L <= 16, decode: a split-key walk. The TPU kernel walks one (batch
//     row, KV head) in order; here its keys are cut into splits of `chunk`
//     keys (a multiple of 64 from 256 to 4096, chosen on the host from B,
//     Hkv and S alone so that the grid (splits, Hkv, B) covers the SMs at
//     least twice where S allows, never from lens, which lives on the
//     device: kernels/flash_attention.py decode_chunk). A block holds all n_rep
//     * L rows of its KV head (16 * MT, MT m16 tiles) over its split. It
//     first reads its rows' mask entries of every 64-key tile of the split
//     and votes (any entry above NEG_INF below the length), its q rows in
//     flight meanwhile (cp.async, scaled once they land); only the live
//     tiles' K, V and mask rows are then copied, in a three-stage cp.async
//     ring. Both products run as mma.sync m16n8k16 (bf16, f32 sums), K and
//     V read by ldmatrix from XOR-swizzled rows; each warp owns an m16 tile
//     and 64 / KW keys of every tile (KW warps split a tile's keys when the
//     rows are few), the KW states merged in shared memory at the end. The
//     block writes an f32 partial (acc, m, l) per row; a split past the
//     row's keys writes nothing, and one whose tiles are all hidden writes
//     the identity (0, NEG_INF, 0). combine_splits merges a row's partials
//     in f32 and rounds o to bf16 once (the TPU kernel's one rounding point
//     for o), the subtrahend floored at NEG_INF / 2, so a row with no key
//     is exactly 0.
//
// Rounding points are the TPU kernels' (_flash_inner): q * scale rounds to
// bf16, scores and the softmax state are f32, p rounds to bf16 for the PV
// product, o = acc / max(l, 1e-30). p is rounded against the running max
// of its tile walk (per split and warp here), as in every flash kernel.
#include "flash_mma.cuh"
#include "mma_sync.cuh"

namespace {

using fmma::BN;
using fmma::LOG2E;
using fmma::MASK_HEAD;
using fmma::MASK_NONE;
using fmma::MASK_SHARED;
using fmma::MaskPlanes;

constexpr int DECODE_MAX_L = 16, MAP_WARPS = 8;

// ---------------------------------------------------------------- the map

// map[((b * P + p) * G + g) * NT + t] = 1 when plane p of batch row b holds
// an entry above NEG_INF in rows 16 g .. 16 g + 15 (below L) and keys 64 t
// .. 64 t + 63 (below min(lens[b], S)). One warp a (plane, group, tile):
// two coalesced 128-byte reads a row, all 32 of a lane in flight at once.
__global__ void __launch_bounds__(MAP_WARPS * 32) mask_tile_map(
    const float* __restrict__ mask, const int* __restrict__ lens, uint8_t* __restrict__ map,
    int L, int S, int P, int G, int NT, long long msb, long long msh) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * MAP_WARPS + (threadIdx.x >> 5), g = blockIdx.y;
  const int b = blockIdx.z / P, p = blockIdx.z % P;
  if (t >= NT) return;
  const int kend = min(__ldg(lens + b), S);
  const float* plane = mask + b * msb + p * msh;
  bool live = false;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = 16 * g + i;
    const float* row = plane + (long long)r * S;
#pragma unroll
    for (int e = 0; e < BN; e += 32) {
      const int key = t * BN + e + lane;
      if (r < L && key < kend) live |= __ldg(row + key) > TLT_NEG_INF;
    }
  }
  live = __any_sync(0xffffffffu, live);
  if (lane == 0) map[((size_t)blockIdx.z * G + g) * NT + t] = live;
}

// ---------------------------------------------------------- the prefill walk

template <int D, int NREP, int MASK>
__global__ void __launch_bounds__(fmma::WARPS * 32, 1) flash_masked_prefill(
    const __nv_bfloat16* __restrict__ q,  // [B, Hq, L, D]
    const __nv_bfloat16* __restrict__ k,  // [B, Hkv, S, D]
    const __nv_bfloat16* __restrict__ v,
    const int* __restrict__ lens,  // [B]
    __nv_bfloat16* __restrict__ out,  // [B, Hq, L, D]
    int Hkv, int L, int S, float scale, MaskPlanes mp) {
  const int h = blockIdx.y, bb = blockIdx.z;
  // The last q tiles first: under causal and document masks they see the
  // most keys, so the longest walks start first and the short ones fill in.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const SlabRows<D> rows{((size_t)bb * Hkv + h) * (size_t)S * D};
  if constexpr (MASK != MASK_NONE)  // the block's own list of live tiles
    mp.list += (((size_t)bb * Hkv + h) * gridDim.x + qt) * mp.ntk;
  fmma::state_tile<D, NREP, false, SlabRows<D>, MASK, false>(
      q, k, v, out, nullptr, nullptr, rows, lens[bb], S, qt, h, bb, Hkv, L, scale, mp);
}

template <int D, int NREP, int MASK>
int launch_prefill(const void* q, const void* k, const void* v, const void* lens, void* out,
                   int B, int Hkv, int L, int S, float scale, const MaskPlanes& mp,
                   cudaStream_t st) {
  constexpr int BQ = fmma::WARPS * 16 / NREP;
  constexpr int SMEM = fmma::smem_bytes<D, fmma::mask_rows<NREP, MASK>()>();
  static const int attr = (int)cudaFuncSetAttribute(
      flash_masked_prefill<D, NREP, MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr) return attr;
  if constexpr (MASK != MASK_NONE) {
    mask_tile_map<<<dim3((mp.ntk + MAP_WARPS - 1) / MAP_WARPS, mp.groups, B * mp.planes),
                    MAP_WARPS * 32, 0, st>>>(mp.mask, static_cast<const int*>(lens), mp.map, L,
                                             S, mp.planes, mp.groups, mp.ntk, mp.msb, mp.msh);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  flash_masked_prefill<D, NREP, MASK><<<dim3((L + BQ - 1) / BQ, Hkv, B),
                                        dim3(fmma::WARPS * 32), SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(out), Hkv, L, S, scale, mp);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------- the decode walk

constexpr int DST = 3;  // ring stages of the decode walk

// KW warps share a key tile's 64 keys when the rows are few (MT m16 tiles):
// MT * KW warps, at most 8.
__host__ __device__ constexpr int dec_kw(int mt) { return mt >= 8 ? 1 : mt >= 4 ? 2 : 4; }

// Mask rows of a decode tile: the L <= 16 positions of a shared plane, or
// every block row of per-head planes.
__host__ __device__ constexpr int dec_mask_rows(int mt, int mode) {
  return mode == MASK_NONE ? 0 : mode == MASK_SHARED ? 16 : 16 * mt;
}

template <int D, int MT, int MODE>
constexpr int dec_smem_bytes() {
  return 16 * MT * D * 2 + DST * (2 * BN * D * 2 + dec_mask_rows(MT, MODE) * BN * 4);
}

template <int D, int MT, int MODE>
__global__ void __launch_bounds__(32 * MT * dec_kw(MT)) flash_masked_decode(
    const __nv_bfloat16* __restrict__ q,  // [B, Hq, L, D]
    const __nv_bfloat16* __restrict__ k,  // [B, Hkv, S, D]
    const __nv_bfloat16* __restrict__ v,
    const int* __restrict__ lens,  // [B]
    MaskPlanes mp,
    float* __restrict__ ws_o,   // [splits, B, Hq, L, D] f32: each split's sum of p v
    float* __restrict__ ws_ml,  // [splits, B, Hq, L, 2] f32: its m and l
    int Hkv, int n_rep, int L, int S, int chunk, float scale) {
  constexpr int KW = dec_kw(MT), NW = MT * KW, THREADS = 32 * NW;
  constexpr int RP = 16 * MT;                            // block rows, padded
  constexpr int KPW = BN / KW, NJ = KPW / 8, KS = KPW / 16;  // a warp's keys of a tile
  constexpr int CH = D / 8, KVB = BN * D * 2;
  constexpr int MRW = dec_mask_rows(MT, MODE);
  constexpr int STG = 2 * KVB + MRW * BN * 4;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ unsigned long long live_bits;
  const uint32_t qs = fmma::smem_u32(smem), ring = qs + RP * D * 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int split = blockIdx.x, h = blockIdx.y, bb = blockIdx.z, B = gridDim.z;
  const int Hq = Hkv * n_rep, R = n_rep * L;
  const int kend = min(lens[bb], S), k0 = split * chunk;
  if (k0 >= kend) return;  // past the row's keys: the combine reads no partial of this split
  const int k1 = min(k0 + chunk, kend), nt = (k1 - k0 + BN - 1) / BN;  // nt <= 64
  const size_t kv0 = ((size_t)bb * Hkv + h) * S;  // row of key 0

  // Block row rr: query head h * n_rep + rr / L at position rr % L. A mask
  // tile's row r: position r of a shared plane, block row r of per-head ones.
  auto mask_row = [&](int r) -> const float* {
    const float* plane = mp.mask + bb * mp.msb;
    if constexpr (MODE == MASK_SHARED) return r < L ? plane + (long long)r * S : nullptr;
    else
      return r < R ? plane + (long long)(h * n_rep + r / L) * mp.msh + (long long)(r % L) * S
                   : nullptr;
  };

  // The block's q rows, raw, into shared memory (padding rows zeros): in
  // flight while the block votes. Scaled when the fragments are built.
  for (int idx = tid; idx < RP * CH; idx += THREADS) {
    const int rr = idx / CH, c = idx % CH;
    const bool ok = rr < R;
    const size_t o = ok ? (((size_t)bb * Hq + h * n_rep + rr / L) * L + rr % L) * D + c * 8 : 0;
    fmma::cp_async16(qs + rswz<D>(rr, c), q + o, ok ? 16 : 0);
  }
  fmma::cp_async_commit();

  // The vote: a tile is live when any of the block's mask entries below the
  // length exceeds NEG_INF. Only live tiles are read below.
  unsigned long long live = nt == 64 ? ~0ull : (1ull << nt) - 1;
  if constexpr (MODE != MASK_NONE) {
    if (tid == 0) live_bits = 0;
    __syncthreads();
    const int mrows = MODE == MASK_SHARED ? L : R;
    for (int j = warp; j < nt; j += NW) {
      bool on = false;
#pragma unroll 4
      for (int r = 0; r < mrows; ++r) {
        const float* row = mask_row(r);
#pragma unroll
        for (int e = lane; e < BN; e += 32) {
          const int key = k0 + j * BN + e;
          if (key < k1) on |= __ldg(row + key) > TLT_NEG_INF;
        }
      }
      if (__any_sync(0xffffffffu, on) && lane == 0) atomicOr(&live_bits, 1ull << j);
    }
    __syncthreads();
    live = live_bits;
  }
  const int nlive = __popcll(live);

  // Live position i (tile j of the split) into its ring stage: K, V and
  // the mask rows. Rows at or past the row's keys are zero-filled.
  auto load = [&](int i, int j) {
    const uint32_t st = ring + (i % DST) * STG;
    const int kb = k0 + j * BN;
    for (int idx = tid; idx < BN * CH; idx += THREADS) {
      const int r = idx / CH, c = idx % CH, pos = kb + r;
      const bool ok = pos < k1;
      const size_t o = ok ? (kv0 + pos) * D + c * 8 : 0;
      fmma::cp_async16(st + rswz<D>(r, c), k + o, ok ? 16 : 0);
      fmma::cp_async16(st + KVB + rswz<D>(r, c), v + o, ok ? 16 : 0);
    }
    if constexpr (MODE != MASK_NONE)
      fmma::load_mask_tile<MRW, THREADS>(st + 2 * KVB, mp, kb / BN, tid, mask_row);
  };
  auto next = [](unsigned long long& rem) {
    const int j = __ffsll(rem) - 1;
    rem &= rem - 1;
    return j;
  };
  unsigned long long to_load = live, to_walk = live;
#pragma unroll
  for (int i = 0; i < DST - 1; ++i) {
    if (i < nlive) load(i, next(to_load));
    fmma::cp_async_commit();
  }

  fmma::cp_async_wait<DST - 1>();
  __syncthreads();  // q landed

  // This warp: m16 tile mt of the rows, keys kw * KPW .. of every tile; its
  // q fragments, q * scale rounded to bf16.
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
  int mr[2];  // the thread's rows (g, g + 8) in a mask tile
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rr = 16 * mt + g + 8 * hh;
    mr[hh] = MODE == MASK_SHARED ? (rr < R ? rr % L : 0) : rr;
  }
  float m[2] = {TLT_NEG_INF, TLT_NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int i = 0; i < nlive; ++i) {
    fmma::cp_async_wait<DST - 2>();
    __syncthreads();  // live position i landed; position i - 1's stage is free
    if (i + DST - 1 < nlive) load(i + DST - 1, next(to_load));
    fmma::cp_async_commit();
    const int j = next(to_walk);
    if (!busy) continue;
    const uint32_t st = ring + (i % DST) * STG;
    const int kb = k0 + j * BN;
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
    if constexpr (MODE != MASK_NONE)
      fmma::add_mask<NJ>(sc, smem + (st + 2 * KVB - qs), mr, kc, tig);
    if (kb + BN > kend) {
#pragma unroll
      for (int e = 0; e < 4 * NJ; ++e)
        if (kb + kc + 8 * (e >> 2) + 2 * tig + (e & 1) >= kend) sc[e] = TLT_NEG_INF;
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
    const size_t row =
        (((size_t)split * B + bb) * Hq + h * n_rep + rr / L) * L + rr % L;
    ws_o[row * D + d] = a;
    if (d == 0) {
      ws_ml[2 * row] = mx;
      ws_ml[2 * row + 1] = ls;
    }
  }
}

// One warp a row of out: the partials of the splits below the row's length,
// weighted by exp(m_s - max m) in f32, o = sum / max(l, 1e-30) rounded once.
template <int D>
__global__ void __launch_bounds__(256) combine_splits(
    const float* __restrict__ ws_o, const float* __restrict__ ws_ml,
    const int* __restrict__ lens, __nv_bfloat16* __restrict__ out, int B, int Hq, int L, int S,
    int chunk) {
  constexpr int E = D / 32;
  const int rows = B * Hq * L;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int kend = min(__ldg(lens + row / (Hq * L)), S);
  const int n = kend > 0 ? (kend + chunk - 1) / chunk : 0;
  float mx = TLT_NEG_INF;
#pragma unroll 8
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, __ldg(ws_ml + 2 * ((size_t)s * rows + row)));
  const float mfl = fmaxf(mx, TLT_NEG_INF / 2);
  float a[E] = {}, ls = 0.f;
#pragma unroll 8
  for (int s = 0; s < n; ++s) {
    const size_t r = (size_t)s * rows + row;
    const float w = expf(__ldg(ws_ml + 2 * r) - mfl);
    ls += w * __ldg(ws_ml + 2 * r + 1);
#pragma unroll
    for (int e = 0; e < E; ++e) a[e] += w * __ldg(ws_o + r * D + lane * E + e);
  }
  const float inv = 1.f / fmaxf(ls, 1e-30f);
  __nv_bfloat16* o = out + (size_t)row * D + lane * E;
#pragma unroll
  for (int e = 0; e < E; ++e) o[e] = __float2bfloat16_rn(a[e] * inv);
}

template <int D, int MT, int MODE>
int launch_decode(const void* q, const void* k, const void* v, const void* lens, void* out,
                  float* ws_o, float* ws_ml, int B, int Hkv, int n_rep, int L, int S, int chunk,
                  float scale, const MaskPlanes& mp, cudaStream_t st) {
  constexpr int SMEM = dec_smem_bytes<D, MT, MODE>();
  static const int attr = (int)cudaFuncSetAttribute(
      flash_masked_decode<D, MT, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr) return attr;
  const int splits = (S + chunk - 1) / chunk;
  flash_masked_decode<D, MT, MODE><<<dim3(splits, Hkv, B), 32 * MT * dec_kw(MT), SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lens), mp, ws_o, ws_ml, Hkv,
      n_rep, L, S, chunk, scale);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int rows = B * Hkv * n_rep * L;
  combine_splits<D><<<(rows + 7) / 8, 256, 0, st>>>(ws_o, ws_ml, static_cast<const int*>(lens),
                                                   static_cast<__nv_bfloat16*>(out), B,
                                                   Hkv * n_rep, L, S, chunk);
  return (int)cudaGetLastError();
}

template <int D, int MODE>
int decode_rows(const void* q, const void* k, const void* v, const void* lens, void* out,
                float* ws_o, float* ws_ml, int B, int Hkv, int n_rep, int L, int S, int chunk,
                float scale, const MaskPlanes& mp, cudaStream_t st) {
  const int R = n_rep * L;
#define TLT_DEC(MM)                                                                      \
  return launch_decode<D, MM, MODE>(q, k, v, lens, out, ws_o, ws_ml, B, Hkv, n_rep, L, S, \
                                    chunk, scale, mp, st)
  if (R <= 16) TLT_DEC(1);
  if (R <= 32) TLT_DEC(2);
  if (R <= 64) TLT_DEC(4);
  TLT_DEC(8);
#undef TLT_DEC
}

// The workspace's layout (bytes, each part 256-aligned): decode, the
// partials ws_o then ws_ml; prefill with a mask, the map then the lists.
struct Workspace {
  size_t a, b;  // sizes of the two parts
};

Workspace workspace(int B, int Hkv, int L, int S, int D, int n_rep, int mode, int chunk) {
  const size_t Hq = (size_t)Hkv * n_rep;
  auto up = [](size_t x) { return (x + 255) / 256 * 256; };
  if (L <= DECODE_MAX_L) {
    const size_t rows = (size_t)((S + chunk - 1) / chunk) * B * Hq * L;
    return {up(rows * D * 4), up(rows * 2 * 4)};
  }
  if (mode == 0) return {0, 0};
  const size_t nt = (S + BN - 1) / BN, bq = fmma::WARPS * 16 / n_rep;
  return {up((size_t)B * (mode == 2 ? Hq : 1) * ((L + 15) / 16) * nt),
          up((size_t)B * Hkv * ((L + bq - 1) / bq) * nt * 4)};
}

}  // namespace

// Bytes of workspace tlt_flash_attention_masked needs for these shapes
// (chunk: keys a decode split, a multiple of 64 up to 4096).
extern "C" long long tlt_flash_attention_masked_workspace(int B, int Hkv, int L, int S, int D,
                                                          int n_rep, int mode, int chunk) {
  const Workspace w = workspace(B, Hkv, L, S, D, n_rep, mode, chunk);
  return (long long)(w.a + w.b);
}

// mode: 0 none, 1 shared, 2 per head (see above). ws: the workspace, at
// least tlt_flash_attention_masked_workspace(...) bytes, 256-byte aligned.
extern "C" int tlt_flash_attention_masked(const void* q, const void* k, const void* v,
                                          const void* lens, const void* mask, void* out,
                                          void* ws, int B, int Hkv, int L, int S, int D,
                                          int n_rep, int mode, long long msb, long long msh,
                                          int chunk, float scale, void* stream) {
  if (L < 1 || S < 1 || mode < 0 || mode > 2 || (mode && !mask)) return (int)cudaErrorInvalidValue;
  if (L <= DECODE_MAX_L && (chunk < BN || chunk % BN || chunk > 64 * BN))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Workspace w = workspace(B, Hkv, L, S, D, n_rep, mode, chunk);
  uint8_t* ws_a = static_cast<uint8_t*>(ws);
  MaskPlanes mp{};
  mp.mask = static_cast<const float*>(mask);
  mp.msb = msb;
  mp.msh = mode == 2 ? msh : 0;
  mp.S = S;
  mp.vec = reinterpret_cast<uintptr_t>(mask) % 16 == 0 && S % 4 == 0 && msb % 4 == 0 &&
           mp.msh % 4 == 0;
  if (L <= DECODE_MAX_L) {
    float* ws_o = reinterpret_cast<float*>(ws_a);
    float* ws_ml = reinterpret_cast<float*>(ws_a + w.a);
#define TLT_MD(DD, MM)                                                                     \
  if (D == DD && mode == MM)                                                               \
    return decode_rows<DD, MM>(q, k, v, lens, out, ws_o, ws_ml, B, Hkv, n_rep, L, S, chunk, \
                               scale, mp, st);
    TLT_MD(64, 0) TLT_MD(64, 1) TLT_MD(64, 2) TLT_MD(128, 0) TLT_MD(128, 1) TLT_MD(128, 2)
#undef TLT_MD
    return (int)cudaErrorInvalidValue;
  }
  mp.map = ws_a;
  mp.list = reinterpret_cast<int*>(ws_a + w.a);
  mp.planes = mode == 2 ? Hkv * n_rep : 1;
  mp.groups = (L + 15) / 16;
  mp.ntk = (S + BN - 1) / BN;
#define TLT_MP(DD, RR, MM)                                                                  \
  if (D == DD && n_rep == RR && mode == MM)                                                 \
    return launch_prefill<DD, RR, MM>(q, k, v, lens, out, B, Hkv, L, S, scale, mp, st);
#define TLT_MP3(DD, RR) TLT_MP(DD, RR, 0) TLT_MP(DD, RR, 1) TLT_MP(DD, RR, 2)
  TLT_MP3(64, 1) TLT_MP3(64, 2) TLT_MP3(64, 4) TLT_MP3(64, 8)
  TLT_MP3(128, 1) TLT_MP3(128, 2) TLT_MP3(128, 4) TLT_MP3(128, 8)
#undef TLT_MP3
#undef TLT_MP
  return (int)cudaErrorInvalidValue;
}
