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
// Design: flash_tile.cuh (shared with the paged kernels), one block per
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
// 0). Design: the tile with decode-shaped rows, as the paged decode kernel
// (all n_rep x L rows of a KV head in one block of 8 * RPW rows, RPW the
// least of 1, 2, 4, 8 that fits). Bound on the H100 at Qwen3-4B's shapes
// (B = 1, 8 KV heads, a full shard of 1024 keys): 4.2 MB of K/V, 1.25 us;
// one block per KV head walks its 1024 keys serially, so the grid (8
// blocks) and the walk's latency bound it, far from the bytes.
#include "flash_mma.cuh"
#include "flash_tile.cuh"

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

template <int D, int NREP, int RPW>
__global__ void __launch_bounds__(flash::WARPS * 32) flash_decode_state(
    const __nv_bfloat16* __restrict__ q,  // [B, Hq, L, D]
    const __nv_bfloat16* __restrict__ k,  // [B, Hkv, S, D] at strides (sb, sh, D, 1)
    const __nv_bfloat16* __restrict__ v,
    const int* __restrict__ lens,  // [B]: keys of the shard per row
    __nv_bfloat16* __restrict__ out,  // [B, Hq, L, D]
    float* __restrict__ m_out,  // [B, Hq, L]
    float* __restrict__ l_out,
    int Hkv, int L, int S, long long sb, long long sh, float scale) {
  const int h = blockIdx.y, bb = blockIdx.z;
  const SlabRows<D> rows{(size_t)bb * sb + (size_t)h * sh};
  flash::tile<D, NREP, RPW, true>(q, k, v, out, rows, lens[bb], S, blockIdx.x, h, bb, Hkv,
                                        L, scale, m_out, l_out);
}

template <int D, int NREP, int RPW>
int launch_decode_state(const void* q, const void* k, const void* v, const void* lens,
                        void* out, void* m, void* l, int B, int Hkv, int L, int S, long long sb,
                        long long sh, float scale, cudaStream_t st) {
  constexpr int BQ = flash::WARPS * RPW / NREP;
  flash_decode_state<D, NREP, RPW><<<dim3((L + BQ - 1) / BQ, Hkv, B),
                                     dim3(flash::WARPS * 32), 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(m), static_cast<float*>(l), Hkv, L,
      S, sb, sh, scale);
  return (int)cudaGetLastError();
}

template <int D, int NREP>
int launch_decode_state_rows(int rpw, const void* q, const void* k, const void* v,
                             const void* lens, void* out, void* m, void* l, int B, int Hkv, int L,
                             int S, long long sb, long long sh, float scale, cudaStream_t st) {
#define TLT_DS(RR) \
  return launch_decode_state<D, NREP, RR>(q, k, v, lens, out, m, l, B, Hkv, L, S, sb, sh, scale, st)
  switch (rpw) {
    case 1: TLT_DS(1);
    case 2: TLT_DS(2);
    case 4: TLT_DS(4);
    default: TLT_DS(8);
  }
#undef TLT_DS
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

// L <= 16: all n_rep * L query rows of a (batch row, KV head) in one block
// when they fit in 64 rows.
extern "C" int tlt_flash_decode_state(const void* q, const void* k, const void* v,
                                      const void* lens, void* out, void* m, void* l, int B,
                                      int Hkv, int L, int S, long long stride_b,
                                      long long stride_h, int D, int n_rep, float scale,
                                      void* stream) {
  if (L < 1 || L > 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int need = n_rep * L;
  const int rpw = need <= 8 ? 1 : need <= 16 ? 2 : need <= 32 ? 4 : 8;
#define TLT_DSR(DD, RR)                                                                        \
  if (D == DD && n_rep == RR)                                                                  \
    return launch_decode_state_rows<DD, RR>(rpw, q, k, v, lens, out, m, l, B, Hkv, L, S,     \
                                            stride_b, stride_h, scale, st);
  TLT_DSR(64, 1) TLT_DSR(64, 2) TLT_DSR(64, 4) TLT_DSR(64, 8)
  TLT_DSR(128, 1) TLT_DSR(128, 2) TLT_DSR(128, 4) TLT_DSR(128, 8)
#undef TLT_DSR
  return (int)cudaErrorInvalidValue;
}
