// Paged attention for Hopper (sm_90a): the paged decode kernel (L <= 16),
// the paged prefill kernel (L > 16), the paged prefix-state walk and the
// paged decode-state walk, all reading K/V from one layer's page pool
// [P, Hkv, ps, D] through a -1-padded block table.
//
// Replaces tiny_llm_tpu/kernels/paged_attention_pallas.py:
//   tlt_paged_decode       -> _paged_decode_gather_kernel (paged_flash_decode_gather),
//                             and _paged_decode_kernel (paged_flash_decode) and
//                             _paged_decode_page_kernel (paged_flash_decode_pages),
//                             which compute the same function
//   tlt_paged_prefill      -> _paged_prefill_kernel (paged_flash_prefill)
//   tlt_paged_prefix_state -> _paged_prefix_state_kernel (paged_prefix_state)
//   tlt_paged_decode_state -> _paged_decode_state_kernel (paged_decode_state)
// The first two compute what the TPU kernels compute: query i of batch row
// b sits at position lens[b] - L + i, where the chunk's own K/V are already
// in the pages, and sees the keys at positions <= its own. -1 table entries
// read the trash page 0 (idle batch rows: table all -1, lens 0, their
// output 0); nothing past the table's width is read.
//
// Paged decode (L <= 16), rows 10-12's function. Bound on the H100: the
// bytes of the live pages' K and V rows plus q and out over 3.35 TB/s,
// 0.3-3 us at 4B's shapes (B = 1 at context 508, B = 4 at 256-1024). What
// held a walk of one block per (batch row, KV head) back was latency: 8 to
// 32 blocks on 132 SMs, each walking its row's context serially. Design:
// the decode-state walk (row 14's, split_walk.cuh) over the whole pool,
// PoolKeys:
//   * a split-key walk: each row's keys cut into splits of `kps` keys,
//     chosen on the host from B, Hkv, the table's width, the page size and
//     the SM count alone (kernels/paged_attention.py decode_split), so the
//     grid (splits, Hkv, B) covers the SMs where the width allows; a split
//     may start and end inside a page. Never from lens or the table, which
//     live on the device.
//   * every table entry is the row's own page as it stands (-1 reads the
//     trash page 0): no list and no ballots; each key row of a 64-key tile
//     finds its page in the table as it is copied, so a tile straddles
//     pages of any size. Both products on mma.sync m16n8k16 (bf16, f32
//     sums), all n_rep x L rows of the KV head in one block.
//   * each block writes an f32 partial (acc, m, l) per row; decode_combine
//     merges a row's partials and writes o rounded to bf16 once (no m, l).
//
// Paged prefill (L > 16), row 13's function. Bound on the H100: operations
// at long contexts (B = 1, L = 128 over 1024 keys: 2.0 us at the bf16
// peak), bytes below. Design: the tensor-core tile of flash_mma.cuh (both
// products as warpgroup MMAs, 128-row q tiles of the KV head's n_rep heads
// over a four-stage cp.async ring of 64-key K/V tiles), causal over the
// row's pages through PageRows (each 16-byte chunk of a K/V row finds its
// page in the block table), each q tile's walk stopping at its last
// visible key, the q tiles issued longest walk first. A serving chunk
// gives few q tiles (L = 128 at 4B's heads: 4 x 8 blocks; a mixed
// sub-chunk of 32: 8), each walking its row's context serially, so where
// they leave SMs idle the keys are split too (kernels/paged_attention.py
// prefill_split, from the shapes alone): paged_flash_prefill_split walks
// one split's key tiles and writes f32 partials, decode_combine merges
// them and writes o. Unsplit, paged_flash_prefill writes o alone (STATE =
// false: staged through shared memory into 16-byte stores).
//
// The prefix-state walk is the split paged prefill's other half: a chunk's
// queries attend to the cached prefix, non-causally (every key below
// prefix_lens[b] is visible to every row; the chunk's own rows, already
// written into the prefix's tail page, are at or past it and never read),
// emitting o and each row's m and l. A row with prefix_len 0 emits the
// identity (0, NEG_INF, 0). Bound on the H100: operations. At 4B's shapes
// (L = 1024, prefix 7168) 120 GFLOP take 0.122 ms at the bf16 peak against
// 46 MB of K/V/q/o (14 us). Design: the tensor-core tile of flash_mma.cuh
// (both products as warpgroup MMAs, 128-row q tiles of the KV head's n_rep
// heads over a four-stage cp.async ring of 64-key K/V tiles), each 16-byte
// chunk of a K/V row finding its page in the block table as PageRows does,
// rows past the prefix zero-filled and masked in the last tile only.
//
// The paged decode-state walk is the sequence-parallel paged decode's per-
// shard half (parallel/sp_attention.py): the pool's page axis is split over
// shards, shard s holding the global pages [base, base + p_loc) as its own
// [p_loc, Hkv, ps, D] slice; the block table keeps global ids. A key on a
// page the shard does not own (another shard's, or a -1 entry) contributes
// nothing; causality on global positions; the state (o, m, l), the
// identity (0, NEG_INF, 0) for a row none of whose visible keys the shard
// owns. Bound on the H100: the owned live pages' K/V bytes plus q, o, m and
// l over 3.35 TB/s, 1/n of the rows' context under the pool's balanced
// striping (~8.6 MB a shard, 2.6 us, at B = 4 and contexts of 130-8000).
// What holds a walk of one block per (batch row, KV head) back is latency:
// B x Hkv blocks on 132 SMs, each reading every table entry of its row to
// find the shard's few pages. Design, row 5's decode walk
// (flash_attention_masked.cu) over the shard's pages (split_walk.cuh,
// ShardPages):
//   * A split-key walk: each row's block table is cut into splits of `per`
//     entries, chosen on the host from B, Hkv, the table's width and the
//     page size alone (kernels/paged_attention.py decode_state_split) so
//     the grid (splits, Hkv, B) covers the SMs at least twice where the
//     width allows; never from lens or the table, which live on the device.
//   * A block scans its entries (one warp, a ballot per 32) and keeps the
//     pages in [base, base + p_loc) below the row's length in a list; the
//     striped pool spreads a shard's pages over the table, so a split may
//     own none, and then it writes the identity's m and l and nothing else.
//   * The list's keys, packed, in tiles of 64 through a three-stage
//     cp.async ring (K, V and each key's global position); rows at or past
//     the length are zero-filled and never read. The block holds all n_rep
//     x L rows of its KV head (16 * MT, MT m16 tiles); both products run as
//     mma.sync m16n8k16 (bf16, f32 sums), K and V read by ldmatrix from
//     XOR-swizzled rows; KW warps split a tile's keys when the rows are
//     few, their states merged in shared memory. A key is masked where its
//     position passes the row's (lens - L + i): that covers the length too.
//   * Each block writes an f32 partial (acc, m, l) per row; state_combine
//     merges a row's partials (those of the splits below its length, the
//     sums only where the split saw a key) in f32 and writes o = acc /
//     max(l, 1e-30) rounded to bf16 once, m and l; a row that saw no key is
//     exactly (0, NEG_INF, 0).
// Rounding points are the TPU kernel's (_flash_inner): q * scale rounds to
// bf16, scores and the state are f32, p rounds to bf16 for the PV product
// (against the running max of its split's walk, per warp).
#include "flash_mma.cuh"
#include "split_walk.cuh"

namespace {

// The causal paged prefill on the tensor-core tile: o alone (no m, l), the
// q tiles longest walk first (the last tile sees the most keys).
template <int D, int NREP>
__global__ void __launch_bounds__(fmma::WARPS * 32, 1) paged_flash_prefill(
    const __nv_bfloat16* __restrict__ q,   // [B, Hq, L, D]
    const __nv_bfloat16* __restrict__ kp,  // [P, Hkv, ps, D]
    const __nv_bfloat16* __restrict__ vp,
    const int* __restrict__ bt,    // [B, maxp], -1 padded
    const int* __restrict__ lens,  // [B]
    __nv_bfloat16* __restrict__ out,  // [B, Hq, L, D]
    int Hkv, int L, int ps, int maxp, int hp, float scale) {
  const int h = blockIdx.y, bb = blockIdx.z;
  const PageRows<D> rows{bt + (size_t)bb * maxp, ps, hp, h};
  fmma::state_tile<D, NREP, true, PageRows<D>, fmma::MASK_NONE, false>(
      q, kp, vp, out, nullptr, nullptr, rows, lens[bb], maxp * ps, gridDim.x - 1 - blockIdx.x, h,
      bb, Hkv, L, scale);
}

// PageRows of one split: key `pos` of the split is key k0 + pos of the row.
template <int D>
struct SplitRows {
  PageRows<D> rows;
  int k0;
  __device__ __forceinline__ size_t operator()(int pos) const { return rows(k0 + pos); }
};

// The same over one split of each row's keys (kps keys): block x takes q
// tile nq - 1 - x / splits (longest walk first) and split x % splits, its
// positions counted from the split's first key (the row's length and the
// table's end shifted with them), and writes its f32 partials for
// decode_combine.
template <int D, int NREP>
__global__ void __launch_bounds__(fmma::WARPS * 32, 1) paged_flash_prefill_split(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ bt,
    const int* __restrict__ lens, float* __restrict__ ws_o, float* __restrict__ ws_ml, int Hkv,
    int L, int ps, int maxp, int hp, int kps, int splits, float scale) {
  const int h = blockIdx.y, bb = blockIdx.z, nq = gridDim.x / splits;
  const int split = blockIdx.x % splits, k0 = split * kps;
  const SplitRows<D> rows{{bt + (size_t)bb * maxp, ps, hp, h}, k0};
  fmma::state_tile<D, NREP, true, SplitRows<D>, fmma::MASK_NONE, false, true>(
      q, kp, vp, nullptr, nullptr, nullptr, rows, lens[bb] - k0, min(kps, maxp * ps - k0),
      nq - 1 - (int)blockIdx.x / splits, h, bb, Hkv, L, scale, fmma::MaskPlanes{},
      fmma::KeySplit{ws_o, ws_ml, split, (int)gridDim.z});
}

template <int D, int NREP>
__global__ void __launch_bounds__(fmma::WARPS * 32, 1) paged_prefix_state(
    const __nv_bfloat16* __restrict__ q,   // [B, Hq, L, D]
    const __nv_bfloat16* __restrict__ kp,  // [P, Hkv, ps, D]
    const __nv_bfloat16* __restrict__ vp,
    const int* __restrict__ bt,           // [B, maxp], -1 padded
    const int* __restrict__ prefix_lens,  // [B]: tokens before the chunk
    __nv_bfloat16* __restrict__ out,      // [B, Hq, L, D]
    float* __restrict__ m_out,            // [B, Hq, L]
    float* __restrict__ l_out,
    int Hkv, int L, int ps, int maxp, float scale) {
  const int h = blockIdx.y, bb = blockIdx.z;
  const PageRows<D> rows{bt + (size_t)bb * maxp, ps, Hkv, h};
  fmma::state_tile<D, NREP, false>(q, kp, vp, out, m_out, l_out, rows, prefix_lens[bb],
                                   maxp * ps, blockIdx.x, h, bb, Hkv, L, scale);
}

template <int D, int NREP>
int launch_prefix(const void* q, const void* kp, const void* vp, const void* bt,
                  const void* lens, void* out, void* m, void* l, int B, int Hkv, int L, int ps,
                  int maxp, float scale, cudaStream_t st) {
  constexpr int BQ = fmma::WARPS * 16 / NREP, SMEM = fmma::smem_bytes<D>();
  static const int attr = (int)cudaFuncSetAttribute(
      paged_prefix_state<D, NREP>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr) return attr;
  paged_prefix_state<D, NREP><<<dim3((L + BQ - 1) / BQ, Hkv, B), dim3(fmma::WARPS * 32), SMEM,
                                st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), static_cast<const int*>(bt),
      static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(out), static_cast<float*>(m),
      static_cast<float*>(l), Hkv, L, ps, maxp, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- the decode-state walk

// The shard walk (split_walk.cuh, ShardPages): splits of `per` table entries.
template <int D, int MT>
__global__ void __launch_bounds__(32 * MT * pds_kw(MT)) paged_state_walk(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ bt,
    const int* __restrict__ lens, float* __restrict__ ws_o, float* __restrict__ ws_ml, int Hkv,
    int n_rep, int L, int ps, int maxp, int base, int p_loc, int per, float scale) {
  state_walk<D, MT>(q, kp, vp, ShardPages{bt, maxp, ps, base, p_loc}, lens, ws_o, ws_ml, Hkv,
                    n_rep, L, per, scale);
}

// The paged decode's walk (PoolKeys): the whole pool, splits of `kps` keys.
template <int D, int MT>
__global__ void __launch_bounds__(32 * MT * pds_kw(MT)) paged_decode_walk(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ bt,
    const int* __restrict__ lens, float* __restrict__ ws_o, float* __restrict__ ws_ml, int Hkv,
    int n_rep, int L, int ps, int maxp, int hp, int kps, float scale) {
  state_walk<D, MT>(q, kp, vp, PoolKeys<D>{bt, maxp, ps, hp}, lens, ws_o, ws_ml, Hkv, n_rep, L,
                    kps, scale);
}

// The paged decode's and the split paged prefill's combine: o alone.
template <int D>
__global__ void __launch_bounds__(256) decode_combine(
    const float* __restrict__ ws_o, const float* __restrict__ ws_ml,
    const int* __restrict__ lens, __nv_bfloat16* __restrict__ out, int B, int Hq, int L,
    int keys_per_split, int splits) {
  combine_rows<D, false>(ws_o, ws_ml, lens, out, nullptr, nullptr, B, Hq, L, keys_per_split,
                         splits);
}

// The splits of the shard walk (`per` table entries each) and of the paged
// decode (`per` keys each).
int walk_splits(bool owned, int maxp, int ps, int per) {
  return owned ? (maxp * ps + per - 1) / per : (maxp + per - 1) / per;
}

// One walk and its combine. OWNED: the paged decode (paged_decode_walk,
// decode_combine: o alone); otherwise the shard walk (paged_state_walk,
// state_combine: o, m and l).
template <int D, int MT, bool OWNED>
int launch_walk(const void* q, const void* kp, const void* vp, const void* bt, const void* lens,
                void* out, void* m, void* l, float* ws_o, float* ws_ml, int B, int Hkv,
                int n_rep, int L, int ps, int maxp, int hp, int base, int p_loc, int per,
                float scale, cudaStream_t st) {
  constexpr int SMEM = pds_smem_bytes<D, MT>();
  static const int attr = (int)cudaFuncSetAttribute(
      OWNED ? (const void*)paged_decode_walk<D, MT> : (const void*)paged_state_walk<D, MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr) return attr;
  const int splits = walk_splits(OWNED, maxp, ps, per);
  const dim3 grid(splits, Hkv, B);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(kp);
  const auto* vv = static_cast<const __nv_bfloat16*>(vp);
  const auto* tt = static_cast<const int*>(bt);
  const auto* ll = static_cast<const int*>(lens);
  if constexpr (OWNED)
    paged_decode_walk<D, MT><<<grid, 32 * MT * pds_kw(MT), SMEM, st>>>(
        qq, kk, vv, tt, ll, ws_o, ws_ml, Hkv, n_rep, L, ps, maxp, hp, per, scale);
  else
    paged_state_walk<D, MT><<<grid, 32 * MT * pds_kw(MT), SMEM, st>>>(
        qq, kk, vv, tt, ll, ws_o, ws_ml, Hkv, n_rep, L, ps, maxp, base, p_loc, per, scale);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int rows = B * Hkv * n_rep * L, keys = OWNED ? per : per * ps;
  auto* o = static_cast<__nv_bfloat16*>(out);
  if constexpr (OWNED)
    decode_combine<D><<<(rows + 7) / 8, 256, 0, st>>>(ws_o, ws_ml, ll, o, B, Hkv * n_rep, L, keys,
                                                      splits);
  else
    state_combine<D><<<(rows + 7) / 8, 256, 0, st>>>(ws_o, ws_ml, ll, o, static_cast<float*>(m),
                                                     static_cast<float*>(l), B, Hkv * n_rep, L,
                                                     keys, splits);
  return (int)cudaGetLastError();
}

// The paged prefill: unsplit (o straight from the tile), or in `splits`
// key ranges of kps keys, the f32 partials in the workspace, merged by
// decode_combine.
template <int D, int NREP>
int launch_prefill(const void* q, const void* kp, const void* vp, const void* bt,
                   const void* lens, void* out, float* ws_o, float* ws_ml, int B, int Hkv, int L,
                   int ps, int maxp, int hp, int kps, int splits, float scale, cudaStream_t st) {
  constexpr int BQ = fmma::WARPS * 16 / NREP, SMEM = fmma::smem_bytes<D>();
  const int nq = (L + BQ - 1) / BQ;
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(kp);
  const auto* vv = static_cast<const __nv_bfloat16*>(vp);
  const auto* tt = static_cast<const int*>(bt);
  const auto* ll = static_cast<const int*>(lens);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (splits == 1) {
    static const int attr = (int)cudaFuncSetAttribute(
        paged_flash_prefill<D, NREP>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (attr) return attr;
    paged_flash_prefill<D, NREP><<<dim3(nq, Hkv, B), dim3(fmma::WARPS * 32), SMEM, st>>>(
        qq, kk, vv, tt, ll, o, Hkv, L, ps, maxp, hp, scale);
    return (int)cudaGetLastError();
  }
  static const int attr = (int)cudaFuncSetAttribute(
      paged_flash_prefill_split<D, NREP>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr) return attr;
  paged_flash_prefill_split<D, NREP><<<dim3(nq * splits, Hkv, B), dim3(fmma::WARPS * 32), SMEM,
                                       st>>>(qq, kk, vv, tt, ll, ws_o, ws_ml, Hkv, L, ps, maxp,
                                             hp, kps, splits, scale);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const int rows = B * Hkv * NREP * L;
  decode_combine<D><<<(rows + 7) / 8, 256, 0, st>>>(ws_o, ws_ml, ll, o, B, Hkv * NREP, L, kps,
                                                    splits);
  return (int)cudaGetLastError();
}

// The walk's instance for n_rep x L rows (MT m16 tiles) and head dim D.
template <bool OWNED>
int walk_rows(const void* q, const void* kp, const void* vp, const void* bt, const void* lens,
              void* out, void* m, void* l, void* ws, long long ws_bytes, int B, int Hkv, int L,
              int ps, int maxp, int hp, int base, int p_loc, int D, int n_rep, int per,
              float scale, void* stream) {
  if (L < 1 || L > 16 || per < 1 || n_rep * L > 128 || maxp < 1 || hp < Hkv ||
      (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  const StateWorkspace w =
      state_workspace(walk_splits(OWNED, maxp, ps, per), B, Hkv, L, D, n_rep);
  if (ws == nullptr || ws_bytes < (long long)(w.o + w.ml)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws_o = static_cast<float*>(ws);
  float* ws_ml = reinterpret_cast<float*>(static_cast<uint8_t*>(ws) + w.o);
  const int R = n_rep * L, mt = R <= 16 ? 1 : R <= 32 ? 2 : R <= 64 ? 4 : 8;
#define TLT_WALK(DD, MM)                                                                      \
  if (D == DD && mt == MM)                                                                    \
    return launch_walk<DD, MM, OWNED>(q, kp, vp, bt, lens, out, m, l, ws_o, ws_ml, B, Hkv,   \
                                      n_rep, L, ps, maxp, hp, base, p_loc, per, scale, st);
  TLT_WALK(64, 1) TLT_WALK(64, 2) TLT_WALK(64, 4) TLT_WALK(64, 8)
  TLT_WALK(128, 1) TLT_WALK(128, 2) TLT_WALK(128, 4) TLT_WALK(128, 8)
#undef TLT_WALK
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Bytes of workspace tlt_paged_decode takes for these shapes (kps: keys a
// split, at least 1).
extern "C" long long tlt_paged_decode_workspace(int B, int Hkv, int L, int maxp, int ps, int D,
                                                int n_rep, int kps) {
  const StateWorkspace w = state_workspace(walk_splits(true, maxp, ps, kps), B, Hkv, L, D, n_rep);
  return (long long)(w.o + w.ml);
}

// L <= 16 over the whole pool, in splits of `kps` keys. ws: the workspace,
// at least tlt_paged_decode_workspace(...) bytes, 256-byte aligned. hp:
// the KV heads a page holds (>= Hkv): kp and vp may be a head shard of a
// pool [P, hp, ps, D], its first head at kp, a page every hp * ps * D
// elements, so a shard is read in place.
extern "C" int tlt_paged_decode(const void* q, const void* kp, const void* vp, const void* bt,
                                const void* lens, void* out, void* ws, long long ws_bytes, int B,
                                int Hkv, int L, int ps, int maxp, int D, int n_rep, int kps,
                                int hp, float scale, void* stream) {
  return walk_rows<true>(q, kp, vp, bt, lens, out, nullptr, nullptr, ws, ws_bytes, B, Hkv, L, ps,
                         maxp, hp, 0, 0, D, n_rep, kps, scale, stream);
}

// Bytes of workspace tlt_paged_prefill takes for these shapes (kps: keys a
// split): 0 where the table's keys fit one split.
extern "C" long long tlt_paged_prefill_workspace(int B, int Hkv, int L, int maxp, int ps, int D,
                                                 int n_rep, int kps) {
  const int splits = walk_splits(true, maxp, ps, kps);
  if (splits <= 1) return 0;
  const StateWorkspace w = state_workspace(splits, B, Hkv, L, D, n_rep);
  return (long long)(w.o + w.ml);
}

// L >= 1, causal over the row's pages, in splits of `kps` keys (a multiple
// of 64 where the table holds more than one split). ws: the workspace, at
// least tlt_paged_prefill_workspace(...) bytes, 256-byte aligned (none for
// one split). hp: as tlt_paged_decode's.
extern "C" int tlt_paged_prefill(const void* q, const void* kp, const void* vp, const void* bt,
                                 const void* lens, void* out, void* ws, long long ws_bytes, int B,
                                 int Hkv, int L, int ps, int maxp, int D, int n_rep, int kps,
                                 int hp, float scale, void* stream) {
  if (L < 1 || maxp < 1 || kps < 1 || hp < Hkv) return (int)cudaErrorInvalidValue;
  const int splits = walk_splits(true, maxp, ps, kps);
  float *ws_o = nullptr, *ws_ml = nullptr;
  if (splits > 1) {
    const StateWorkspace w = state_workspace(splits, B, Hkv, L, D, n_rep);
    if (kps % fmma::BN || ws == nullptr || ws_bytes < (long long)(w.o + w.ml))
      return (int)cudaErrorInvalidValue;
    ws_o = static_cast<float*>(ws);
    ws_ml = reinterpret_cast<float*>(static_cast<uint8_t*>(ws) + w.o);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TLT_PF(DD, RR)                                                                          \
  if (D == DD && n_rep == RR)                                                                   \
    return launch_prefill<DD, RR>(q, kp, vp, bt, lens, out, ws_o, ws_ml, B, Hkv, L, ps, maxp, \
                                  hp, kps, splits, scale, st);
  TLT_PF(64, 1) TLT_PF(64, 2) TLT_PF(64, 4) TLT_PF(64, 8)
  TLT_PF(128, 1) TLT_PF(128, 2) TLT_PF(128, 4) TLT_PF(128, 8)
#undef TLT_PF
  return (int)cudaErrorInvalidValue;
}

extern "C" int tlt_paged_prefix_state(const void* q, const void* kp, const void* vp,
                                      const void* bt, const void* prefix_lens, void* out, void* m,
                                      void* l, int B, int Hkv, int L, int ps, int maxp, int D,
                                      int n_rep, float scale, void* stream) {
  if (L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TLT_PS(DD, RR)                                                                        \
  if (D == DD && n_rep == RR)                                                                 \
    return launch_prefix<DD, RR>(q, kp, vp, bt, prefix_lens, out, m, l, B, Hkv, L, ps, maxp, \
                                 scale, st);
  TLT_PS(64, 1) TLT_PS(64, 2) TLT_PS(64, 4) TLT_PS(64, 8)
  TLT_PS(128, 1) TLT_PS(128, 2) TLT_PS(128, 4) TLT_PS(128, 8)
#undef TLT_PS
  return (int)cudaErrorInvalidValue;
}

// Bytes of workspace tlt_paged_decode_state takes for these shapes (per:
// table entries a split, 1 to PDS_MAX_ENTRIES).
extern "C" long long tlt_paged_decode_state_workspace(int B, int Hkv, int L, int maxp, int D,
                                                      int n_rep, int per) {
  const StateWorkspace w = state_workspace(walk_splits(false, maxp, 0, per), B, Hkv, L, D, n_rep);
  return (long long)(w.o + w.ml);
}

// L <= 16 over the shard's pages, in splits of `per` table entries. ws: the
// workspace, at least tlt_paged_decode_state_workspace(...) bytes,
// 256-byte aligned.
extern "C" int tlt_paged_decode_state(const void* q, const void* kp, const void* vp,
                                      const void* bt, const void* lens, void* out, void* m,
                                      void* l, void* ws, long long ws_bytes, int B, int Hkv,
                                      int L, int ps, int maxp, int base, int p_loc, int D,
                                      int n_rep, int per, float scale, void* stream) {
  if (per > PDS_MAX_ENTRIES) return (int)cudaErrorInvalidValue;
  return walk_rows<false>(q, kp, vp, bt, lens, out, m, l, ws, ws_bytes, B, Hkv, L, ps, maxp, Hkv,
                          base, p_loc, D, n_rep, per, scale, stream);
}
