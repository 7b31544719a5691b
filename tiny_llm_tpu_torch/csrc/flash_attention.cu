// K3: causal flash attention over dense K/V with a per-row length clamp,
// for Hopper (sm_90a), and its state-emitting twins for the split paged
// prefill and the sequence-parallel decode.
//
// tlt_flash_attention replaces
// tiny_llm_tpu/kernels/flash_attention_pallas.py::_prefill_kernel (through
// _flash_prefill / flash_attention_pallas for L > 16), and covers its
// L <= 16 sibling _decode_kernel (_flash_decode) too: it takes any L >= 1.
// Query i of row b sits at position lens[b] - L + i and sees the keys at
// positions <= its own; nothing at or past lens[b] or the slab's S is read,
// and a row that sees no key emits exactly 0.
// Bound on the H100: bytes at a prompt chunk over a short context (L = 128
// over 128 keys at 4B's heads: q, k, v and out, 2.6 MB, 0.8 us), operations
// at a long one (L = S = 1024: 8.6 GFLOP of causal pairs, 8.7 us at the
// bf16 peak). What held the SIMT tile it replaces back: the products on the FP32
// pipes (about 2 % of the tensor-core rate), copies that never overlapped
// compute, and at L <= 16 a grid of B x Hkv blocks (8 on 132 SMs at 4B's
// heads) each walking its row's keys serially. Design, two routes by L,
// both on the tensor cores:
//   * L <= 16: row 6's split-key walk over the slab (split_walk.cuh,
//     SlabKeys: the slab's batch and head strides), the same
//     flash_decode_walk instances, in splits of `kps` keys
//     (kernels/flash_attention.py flash_split), both products on mma.sync
//     (HMMA); the walk masks each key past the row's position, which covers
//     causality. Then flash_combine, o alone: a row reads the splits at or
//     before its position. Two launches a call.
//   * L > 16: the wgmma tile of flash_mma.cuh (HGMMA), causal over SlabRows,
//     o alone (STATE = false: q by cp.async, o staged into 16-byte stores),
//     the q tiles issued longest walk first (flash_causal_tile). Where the
//     q tiles leave SMs idle the keys are split too (flash_causal_split:
//     the tile's SPLIT option over one key range, f32 partials) and
//     flash_combine merges them.
// K and V may be a strided view of a slab (a head shard of it under tensor
// parallelism): key p of (b, h) at b * sb + h * sh + p * D, so a shard is
// read in place.
// The split size comes from the shapes and the SM count alone, never from
// lens, which lives on the device: reading it would sync and break a CUDA
// graph's capture. Rounding points are the TPU kernels' (_flash_inner): q *
// scale rounds to bf16, scores and the softmax state are f32, p rounds to
// bf16 for the PV product, o = acc / max(l, 1e-30) rounds to bf16 once.
//
// tlt_flash_prefill_state replaces
// tiny_llm_tpu/kernels/flash_attention_pallas.py::_prefill_state_kernel
// (flash_prefill_state_pallas): the same causal attention, emitting o
// locally normalised and each row's m and l as f32 [B, Hq, L]. The split
// paged prefill runs it on a chunk's own K/V at chunk-local positions (lens
// = L); sequence-parallel prefill runs it on each shard at virtual lengths
// (below 0: the shard is past every query; above S: every key visible).
// Bound on the H100: operations. At 4B's shapes (L = 2048, 32 heads) 34
// GFLOP of causal pairs take 35 us at the bf16 peak against 42 MB of
// q/k/v/o (13 us). Design: the tensor-core tile of flash_mma.cuh (both
// products as warpgroup MMAs, 128-row q tiles of the KV head's n_rep heads,
// a four-stage cp.async ring of 64-key K/V tiles, the softmax of one tile
// under the P V of the one before), causal: each q tile's walk stops at its
// last visible key, the longest walks are issued first, and only a tile
// that crosses a row's position is masked element by element.
//
// tlt_flash_decode_state replaces
// tiny_llm_tpu/kernels/flash_attention_pallas.py::_decode_state_kernel
// (flash_decode_state_pallas): decode (L <= 16) over ONE shard of a
// sequence-sharded KV slab, emitting o locally normalised and each row's m
// and l, which the sequence-parallel attention (parallel/sp_attention.py)
// combines across shards. The shard is a strided view of the slab: K/V rows
// of head h of batch row b start at b * stride_b + h * stride_h (elements),
// so no shard is copied. A shard with no key for a row gives (0, NEG_INF,
// 0). Bound on the H100 at Qwen3-4B's shapes (B = 1, 8 KV heads, a full
// shard of 1024 keys): 4.2 MB of K/V, 1.25 us. A walk of one block per
// (batch row, KV head), 8 blocks each walking its 1024 keys serially, is
// bound by its latency, far from the bytes. Design: the split-key walk of
// split_walk.cuh (rows 10-14's) over the slab (SlabKeys): each row's keys
// cut into splits of `kps` keys, whole 64-key tiles chosen on the host from
// B, Hkv, S and the SM count alone (kernels/paged_attention.py
// decode_split, with S for the table's width: at B = 1 and 8 KV heads, 8
// splits of 128, a 64-block grid), never from lens, which lives on the
// device; both products on mma.sync (HMMA); each block's f32 partial per
// row, merged by state_combine into o, m and l (the identity exactly where
// a row saw no key of the shard).
#include "flash_mma.cuh"
#include "split_walk.cuh"

namespace {

template <int D, int NREP>
__global__ void __launch_bounds__(fmma::WARPS * 32, 1) flash_prefill_state(
    const __nv_bfloat16* __restrict__ q,  // [B, Hq, L, D]
    const __nv_bfloat16* __restrict__ k,  // [B, Hkv, S, D]
    const __nv_bfloat16* __restrict__ v,
    const int* __restrict__ lens,  // [B]
    __nv_bfloat16* __restrict__ out,  // [B, Hq, L, D]
    float* __restrict__ m_out,  // [B, Hq, L]
    float* __restrict__ l_out,
    int Hkv, int L, int S, float scale) {
  const int h = blockIdx.y, bb = blockIdx.z;
  const SlabRows<D> rows{((size_t)bb * Hkv + h) * (size_t)S * D};
  // The q tiles longest walk first: the last tile sees the most keys.
  fmma::state_tile<D, NREP, true>(q, k, v, out, m_out, l_out, rows, lens[bb], S,
                                  gridDim.x - 1 - blockIdx.x, h, bb, Hkv, L, scale);
}

template <int D, int NREP>
int launch_state(const void* q, const void* k, const void* v, const void* lens, void* out,
                 void* m, void* l, int B, int Hkv, int L, int S, float scale, cudaStream_t st) {
  constexpr int BQ = fmma::WARPS * 16 / NREP, SMEM = fmma::smem_bytes<D>();
  static const int attr = (int)cudaFuncSetAttribute(
      flash_prefill_state<D, NREP>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr) return attr;
  flash_prefill_state<D, NREP><<<dim3((L + BQ - 1) / BQ, Hkv, B), dim3(fmma::WARPS * 32), SMEM,
                                 st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(m), static_cast<float*>(l), Hkv, L,
      S, scale);
  return (int)cudaGetLastError();
}

// The shard decode state's walk (split_walk.cuh, SlabKeys): splits of
// `kps` keys of the slab's strided rows.
template <int D, int MT>
__global__ void __launch_bounds__(32 * MT * pds_kw(MT)) flash_decode_walk(
    const __nv_bfloat16* __restrict__ q,  // [B, Hq, L, D]
    const __nv_bfloat16* __restrict__ k,  // [B, Hkv, S, D] at strides (sb, sh, D, 1)
    const __nv_bfloat16* __restrict__ v,
    const int* __restrict__ lens,  // [B]: keys of the shard per row
    float* __restrict__ ws_o, float* __restrict__ ws_ml, int Hkv, int n_rep, int L, int S,
    long long sb, long long sh, int kps, float scale) {
  state_walk<D, MT>(q, k, v, SlabKeys<D>{sb, sh, S}, lens, ws_o, ws_ml, Hkv, n_rep, L, kps, scale);
}

template <int D, int MT>
int launch_decode_state(const void* q, const void* k, const void* v, const void* lens,
                        void* out, void* m, void* l, float* ws_o, float* ws_ml, int B, int Hkv,
                        int L, int S, long long sb, long long sh, int n_rep, int kps, float scale,
                        cudaStream_t st) {
  constexpr int SMEM = pds_smem_bytes<D, MT>();
  static const int attr = (int)cudaFuncSetAttribute(
      flash_decode_walk<D, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr) return attr;
  const int splits = (S + kps - 1) / kps;
  const auto* ll = static_cast<const int*>(lens);
  flash_decode_walk<D, MT><<<dim3(splits, Hkv, B), 32 * MT * pds_kw(MT), SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), ll, ws_o, ws_ml, Hkv, n_rep, L, S, sb, sh, kps, scale);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const int rows = B * Hkv * n_rep * L;
  state_combine<D><<<(rows + 7) / 8, 256, 0, st>>>(ws_o, ws_ml, ll, static_cast<__nv_bfloat16*>(out),
                                                   static_cast<float*>(m), static_cast<float*>(l),
                                                   B, Hkv * n_rep, L, kps, splits);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- K3 (tlt_flash_attention)

// L > 16, unsplit: the causal tile over the slab, o alone, the q tiles
// longest walk first (the last tile sees the most keys).
template <int D, int NREP>
__global__ void __launch_bounds__(fmma::WARPS * 32, 1) flash_causal_tile(
    const __nv_bfloat16* __restrict__ q,  // [B, Hq, L, D]
    const __nv_bfloat16* __restrict__ k,  // [B, Hkv, S, D] at strides (sb, sh, D, 1)
    const __nv_bfloat16* __restrict__ v,
    const int* __restrict__ lens,  // [B]
    __nv_bfloat16* __restrict__ out,  // [B, Hq, L, D]
    int Hkv, int L, int S, long long sb, long long sh, float scale) {
  const int h = blockIdx.y, bb = blockIdx.z;
  const SlabRows<D> rows{(size_t)bb * sb + (size_t)h * sh};
  fmma::state_tile<D, NREP, true, SlabRows<D>, fmma::MASK_NONE, false>(
      q, k, v, out, nullptr, nullptr, rows, lens[bb], S, gridDim.x - 1 - blockIdx.x, h, bb, Hkv,
      L, scale);
}

// The same over one split of each row's keys (kps keys): block x takes q
// tile nq - 1 - x / splits (longest walk first) and split x % splits, its
// positions counted from the split's first key k0 (the row's length and
// the slab's end shifted with them: the split's rows start k0 rows into
// the head's), and writes its f32 partials for flash_combine.
template <int D, int NREP>
__global__ void __launch_bounds__(fmma::WARPS * 32, 1) flash_causal_split(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ lens,
    float* __restrict__ ws_o, float* __restrict__ ws_ml, int Hkv, int L, int S, long long sb,
    long long sh, int kps, int splits, float scale) {
  const int h = blockIdx.y, bb = blockIdx.z, nq = gridDim.x / splits;
  const int split = blockIdx.x % splits, k0 = split * kps;
  const SlabRows<D> rows{(size_t)bb * sb + (size_t)h * sh + (size_t)k0 * D};
  fmma::state_tile<D, NREP, true, SlabRows<D>, fmma::MASK_NONE, false, true>(
      q, k, v, nullptr, nullptr, nullptr, rows, lens[bb] - k0, min(kps, S - k0),
      nq - 1 - (int)blockIdx.x / splits, h, bb, Hkv, L, scale, fmma::MaskPlanes{},
      fmma::KeySplit{ws_o, ws_ml, split, (int)gridDim.z});
}

// K3's combine, o alone: each row merges the splits at or before its
// position (a split past it saw no key of the row, or wrote nothing).
template <int D>
__global__ void __launch_bounds__(256) flash_combine(
    const float* __restrict__ ws_o, const float* __restrict__ ws_ml,
    const int* __restrict__ lens, __nv_bfloat16* __restrict__ out, int B, int Hq, int L,
    int keys_per_split, int splits) {
  combine_rows<D, false>(ws_o, ws_ml, lens, out, nullptr, nullptr, B, Hq, L, keys_per_split,
                         splits);
}

int k3_splits(int S, int kps) { return (S + kps - 1) / kps; }

// L <= 16: row 6's walk over the slab in splits of kps keys, then the
// o-only combine.
template <int D, int MT>
int launch_k3_walk(const void* q, const void* k, const void* v, const void* lens, void* out,
                   float* ws_o, float* ws_ml, int B, int Hkv, int n_rep, int L, int S,
                   long long sb, long long sh, int kps, float scale, cudaStream_t st) {
  constexpr int SMEM = pds_smem_bytes<D, MT>();
  static const int attr = (int)cudaFuncSetAttribute(
      flash_decode_walk<D, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr) return attr;
  const int splits = k3_splits(S, kps);
  const auto* ll = static_cast<const int*>(lens);
  flash_decode_walk<D, MT><<<dim3(splits, Hkv, B), 32 * MT * pds_kw(MT), SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), ll, ws_o, ws_ml, Hkv, n_rep, L, S, sb, sh, kps,
      scale);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const int rows = B * Hkv * n_rep * L;
  flash_combine<D><<<(rows + 7) / 8, 256, 0, st>>>(ws_o, ws_ml, ll, static_cast<__nv_bfloat16*>(out),
                                                   B, Hkv * n_rep, L, kps, splits);
  return (int)cudaGetLastError();
}

// L > 16: the causal tile, unsplit (o straight from the tile) or in
// `splits` key ranges of kps keys merged by flash_combine.
template <int D, int NREP>
int launch_k3_tile(const void* q, const void* k, const void* v, const void* lens, void* out,
                   float* ws_o, float* ws_ml, int B, int Hkv, int L, int S, long long sb,
                   long long sh, int kps, float scale, cudaStream_t st) {
  constexpr int BQ = fmma::WARPS * 16 / NREP, SMEM = fmma::smem_bytes<D>();
  const int nq = (L + BQ - 1) / BQ, splits = k3_splits(S, kps);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  const auto* ll = static_cast<const int*>(lens);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (splits == 1) {
    static const int attr = (int)cudaFuncSetAttribute(
        flash_causal_tile<D, NREP>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (attr) return attr;
    flash_causal_tile<D, NREP><<<dim3(nq, Hkv, B), dim3(fmma::WARPS * 32), SMEM, st>>>(
        qq, kk, vv, ll, o, Hkv, L, S, sb, sh, scale);
    return (int)cudaGetLastError();
  }
  static const int attr = (int)cudaFuncSetAttribute(
      flash_causal_split<D, NREP>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr) return attr;
  flash_causal_split<D, NREP><<<dim3(nq * splits, Hkv, B), dim3(fmma::WARPS * 32), SMEM, st>>>(
      qq, kk, vv, ll, ws_o, ws_ml, Hkv, L, S, sb, sh, kps, splits, scale);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const int rows = B * Hkv * NREP * L;
  flash_combine<D><<<(rows + 7) / 8, 256, 0, st>>>(ws_o, ws_ml, ll, o, B, Hkv * NREP, L, kps,
                                                   splits);
  return (int)cudaGetLastError();
}

// K3's partials: the walk's always (L <= 16), the tile's where it splits.
long long k3_workspace(int B, int Hkv, int L, int S, int D, int n_rep, int kps) {
  const int splits = k3_splits(S, kps);
  if (L > 16 && splits <= 1) return 0;
  const StateWorkspace w = state_workspace(splits, B, Hkv, L, D, n_rep);
  return (long long)(w.o + w.ml);
}

}  // namespace

// Bytes of workspace tlt_flash_attention takes for these shapes (kps: keys
// a split, at least 1): 0 where L > 16 and the slab's keys fit one split.
extern "C" long long tlt_flash_attention_workspace(int B, int Hkv, int L, int S, int D,
                                                   int n_rep, int kps) {
  if (kps < 1) return 0;
  return k3_workspace(B, Hkv, L, S, D, n_rep, kps);
}

// Any L >= 1 over the slab's S keys in splits of `kps` keys (above L = 16,
// a multiple of 64 where the slab holds more than one split). ws: the
// workspace, at least tlt_flash_attention_workspace(...) bytes, 256-byte
// aligned (none for one split above L = 16). sb, sh: K's and V's batch and
// head strides in elements (Hkv * S * D and S * D for a whole slab; a
// multiple of 8, so that every row starts 16-byte aligned).
extern "C" int tlt_flash_attention(const void* q, const void* k, const void* v, const void* lens,
                                   void* out, void* ws, long long ws_bytes, int B, int Hkv, int L,
                                   int S, long long sb, long long sh, int D, int n_rep, int kps,
                                   float scale, void* stream) {
  if (L < 1 || S < 1 || kps < 1 || sb % 8 || sh % 8) return (int)cudaErrorInvalidValue;
  const long long need = k3_workspace(B, Hkv, L, S, D, n_rep, kps);
  if (need > 0 && (ws == nullptr || ws_bytes < need)) return (int)cudaErrorInvalidValue;
  if (L > 16 && k3_splits(S, kps) > 1 && kps % fmma::BN) return (int)cudaErrorInvalidValue;
  float* ws_o = static_cast<float*>(ws);
  float* ws_ml = nullptr;
  if (need > 0)
    ws_ml = reinterpret_cast<float*>(static_cast<uint8_t*>(ws) +
                                     state_workspace(k3_splits(S, kps), B, Hkv, L, D, n_rep).o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L <= 16) {
    const int R = n_rep * L, mt = R <= 16 ? 1 : R <= 32 ? 2 : R <= 64 ? 4 : 8;
#define TLT_K3W(DD, MM)                                                                         \
  if (D == DD && mt == MM)                                                                      \
    return launch_k3_walk<DD, MM>(q, k, v, lens, out, ws_o, ws_ml, B, Hkv, n_rep, L, S, sb,  \
                                  sh, kps, scale, st);
    TLT_K3W(64, 1) TLT_K3W(64, 2) TLT_K3W(64, 4) TLT_K3W(64, 8)
    TLT_K3W(128, 1) TLT_K3W(128, 2) TLT_K3W(128, 4) TLT_K3W(128, 8)
#undef TLT_K3W
    return (int)cudaErrorInvalidValue;
  }
#define TLT_K3(DD, RR)                                                                     \
  if (D == DD && n_rep == RR)                                                              \
    return launch_k3_tile<DD, RR>(q, k, v, lens, out, ws_o, ws_ml, B, Hkv, L, S, sb, sh, kps, \
                                  scale, st);
  TLT_K3(64, 1) TLT_K3(64, 2) TLT_K3(64, 4) TLT_K3(64, 8)
  TLT_K3(128, 1) TLT_K3(128, 2) TLT_K3(128, 4) TLT_K3(128, 8)
#undef TLT_K3
  return (int)cudaErrorInvalidValue;
}

extern "C" int tlt_flash_prefill_state(const void* q, const void* k, const void* v,
                                       const void* lens, void* out, void* m, void* l, int B,
                                       int Hkv, int L, int S, int D, int n_rep, float scale,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TLT_ST(DD, RR) \
  if (D == DD && n_rep == RR)   \
    return launch_state<DD, RR>(q, k, v, lens, out, m, l, B, Hkv, L, S, scale, st);
  TLT_ST(64, 1) TLT_ST(64, 2) TLT_ST(64, 4) TLT_ST(64, 8)
  TLT_ST(128, 1) TLT_ST(128, 2) TLT_ST(128, 4) TLT_ST(128, 8)
#undef TLT_ST
  return (int)cudaErrorInvalidValue;
}

// Bytes of workspace tlt_flash_decode_state takes for these shapes (kps:
// keys a split, at least 1).
extern "C" long long tlt_flash_decode_state_workspace(int B, int Hkv, int L, int S, int D,
                                                      int n_rep, int kps) {
  const StateWorkspace w = state_workspace((S + kps - 1) / kps, B, Hkv, L, D, n_rep);
  return (long long)(w.o + w.ml);
}

// L <= 16 over the shard's S keys in splits of `kps`, all n_rep * L rows of
// a (batch row, KV head) in one block of each split. ws: the workspace, at
// least tlt_flash_decode_state_workspace(...) bytes, 256-byte aligned.
extern "C" int tlt_flash_decode_state(const void* q, const void* k, const void* v,
                                      const void* lens, void* out, void* m, void* l, void* ws,
                                      long long ws_bytes, int B, int Hkv, int L, int S,
                                      long long stride_b, long long stride_h, int D, int n_rep,
                                      int kps, float scale, void* stream) {
  if (L < 1 || L > 16 || S < 1 || kps < 1 || n_rep * L > 128) return (int)cudaErrorInvalidValue;
  const StateWorkspace w = state_workspace((S + kps - 1) / kps, B, Hkv, L, D, n_rep);
  if (ws == nullptr || ws_bytes < (long long)(w.o + w.ml)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws_o = static_cast<float*>(ws);
  float* ws_ml = reinterpret_cast<float*>(static_cast<uint8_t*>(ws) + w.o);
  const int R = n_rep * L, mt = R <= 16 ? 1 : R <= 32 ? 2 : R <= 64 ? 4 : 8;
#define TLT_DS(DD, MM)                                                                       \
  if (D == DD && mt == MM)                                                                   \
    return launch_decode_state<DD, MM>(q, k, v, lens, out, m, l, ws_o, ws_ml, B, Hkv, L, S, \
                                       stride_b, stride_h, n_rep, kps, scale, st);
  TLT_DS(64, 1) TLT_DS(64, 2) TLT_DS(64, 4) TLT_DS(64, 8)
  TLT_DS(128, 1) TLT_DS(128, 2) TLT_DS(128, 4) TLT_DS(128, 8)
#undef TLT_DS
  return (int)cudaErrorInvalidValue;
}
