// K3: causal flash attention over dense K/V with a per-row length clamp,
// for Hopper (sm_90a), and its state-emitting twin for the split paged
// prefill.
//
// Replaces tiny_llm_tpu/kernels/flash_attention_pallas.py::_prefill_kernel
// (through _flash_prefill / flash_attention_pallas for L > 16), and covers
// its L <= 16 sibling _decode_kernel (_flash_decode) too: this kernel takes
// any L >= 1. Query i of row b sits at position lens[b] - L + i and sees
// keys at positions <= its own.
//
// Bound on the H100: at the prefill shapes (L = 128, context 128) the
// q/k/v/out bytes and the 4*L*S*D*Hq operations are both small; the
// kernel is bounded by its own SIMT arithmetic and the launch.
//
// Design: flash_tile.cuh, one block per
// (q tile, kv head, batch row), 8 warps, 64 query rows per block = the kv
// head's n_rep query heads times 64/n_rep positions; K/V rows of head h of
// row b are the slab's [b, h, 0:S).
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
#include "flash_tile.cuh"
#include "split_walk.cuh"

namespace {

template <int D, int NREP>
__global__ void __launch_bounds__(flash::WARPS * 32) flash_prefill(
    const __nv_bfloat16* __restrict__ q,  // [B, Hq, L, D]
    const __nv_bfloat16* __restrict__ k,  // [B, Hkv, S, D]
    const __nv_bfloat16* __restrict__ v,
    const int* __restrict__ lens,  // [B]
    __nv_bfloat16* __restrict__ out,  // [B, Hq, L, D]
    int Hkv, int L, int S, float scale) {
  const int h = blockIdx.y, bb = blockIdx.z;
  const SlabRows<D> rows{((size_t)bb * Hkv + h) * (size_t)S * D};
  flash::tile<D, NREP, 8>(q, k, v, out, rows, lens[bb], S, blockIdx.x, h, bb, Hkv, L, scale);
}

template <int D, int NREP>
int launch(const void* q, const void* k, const void* v, const void* lens, void* out, int B,
           int Hkv, int L, int S, float scale, cudaStream_t st) {
  constexpr int BQ = flash::WARPS * 8 / NREP;
  flash_prefill<D, NREP><<<dim3((L + BQ - 1) / BQ, Hkv, B), dim3(flash::WARPS * 32), 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(out), Hkv, L, S, scale);
  return (int)cudaGetLastError();
}

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
