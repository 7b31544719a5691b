// Paged attention for Hopper (sm_90a): the paged decode kernel (L <= 16),
// the paged prefill kernel (L > 16) and the paged prefix-state walk, all
// reading K/V from one layer's page pool [P, Hkv, ps, D] through a
// -1-padded block table.
//
// Replaces tiny_llm_tpu/kernels/paged_attention_pallas.py:
//   tlt_paged_decode       -> _paged_decode_gather_kernel (paged_flash_decode_gather)
//   tlt_paged_prefill      -> _paged_prefill_kernel (paged_flash_prefill)
//   tlt_paged_prefix_state -> _paged_prefix_state_kernel (paged_prefix_state)
//   tlt_paged_decode_state -> _paged_decode_state_kernel (paged_decode_state)
// Both compute what the TPU kernels compute: query i of batch row b sits at
// position lens[b] - L + i, where the chunk's own K/V are already in the
// pages, and sees the keys at positions <= its own. -1 table entries read
// the trash page 0 (idle batch rows: table all -1, their output is
// discarded); nothing past the table's width is read.
//
// Bound on the H100: the bytes of the live pages' K and V rows plus q and
// out, over 3.35 TB/s: ~2 MB and ~0.7 us for 8 KV heads at context 500 at
// 4B's shapes. At decode sizes the kernels are latency-bound (the walk
// over pages is serial in each block, and the grid is only B x Hkv).
//
// Design (decode, prefill and the decode-state walk): flash_tile.cuh, the
// SIMT tile K3 runs, with PageRows addressing:
// each lane that loads a key row looks its page up in the block table, so
// a 32-key tile may straddle pages of any size. The walk is bounded by the
// q tile's causal limit, i.e. by the row's live pages.
//   decode:  one block per (batch row, KV head) holding all n_rep x L query
//            rows (8 * RPW rows, RPW the least of 1, 2, 4, 8 that fits), so
//            each page tile in shared memory serves all of them;
//   prefill: 64-row q tiles (n_rep heads x 64/n_rep positions); tiles past
//            a q tile's causal limit are skipped, as the TPU kernel's
//            `live` predicate skips them.
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
// [p_loc, Hkv, ps, D] slice; the block table keeps global ids. It is the
// decode walk above over OwnedPageRows: a key on a page the shard does not
// own (another shard's, or a -1 entry) is masked and never loaded, and a
// 32-key tile with none of the shard's keys is skipped; causality on global
// positions; the STATE epilogue (o, m, l), the identity (0, NEG_INF, 0) for
// a row none of whose visible pages the shard owns. Bound on the H100: the
// owned live pages' K/V bytes plus q, o, m and l over 3.35 TB/s, so 1/n of
// the rows' context under the pool's balanced striping. The walk is as
// serial as the decode kernel's, over the shard's pages only.
#include "flash_mma.cuh"
#include "flash_tile.cuh"

namespace {

template <int D, int NREP, int RPW>
__global__ void __launch_bounds__(flash::WARPS * 32) paged_flash(
    const __nv_bfloat16* __restrict__ q,   // [B, Hq, L, D]
    const __nv_bfloat16* __restrict__ kp,  // [P, Hkv, ps, D]
    const __nv_bfloat16* __restrict__ vp,
    const int* __restrict__ bt,    // [B, maxp], -1 padded
    const int* __restrict__ lens,  // [B]
    __nv_bfloat16* __restrict__ out,  // [B, Hq, L, D]
    int Hkv, int L, int ps, int maxp, float scale) {
  const int h = blockIdx.y, bb = blockIdx.z;
  const PageRows<D> rows{bt + (size_t)bb * maxp, ps, Hkv, h};
  flash::tile<D, NREP, RPW>(q, kp, vp, out, rows, lens[bb], maxp * ps, blockIdx.x, h, bb, Hkv,
                            L, scale);
}

template <int D, int NREP, int RPW>
int launch(const void* q, const void* kp, const void* vp, const void* bt, const void* lens,
           void* out, int B, int Hkv, int L, int ps, int maxp, float scale, cudaStream_t st) {
  constexpr int BQ = flash::WARPS * RPW / NREP;
  paged_flash<D, NREP, RPW><<<dim3((L + BQ - 1) / BQ, Hkv, B), dim3(flash::WARPS * 32), 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), static_cast<const int*>(bt),
      static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(out), Hkv, L, ps, maxp, scale);
  return (int)cudaGetLastError();
}

template <int D, int NREP>
int launch_rows(int rpw, const void* q, const void* kp, const void* vp, const void* bt,
                const void* lens, void* out, int B, int Hkv, int L, int ps, int maxp,
                float scale, cudaStream_t st) {
  switch (rpw) {
    case 1: return launch<D, NREP, 1>(q, kp, vp, bt, lens, out, B, Hkv, L, ps, maxp, scale, st);
    case 2: return launch<D, NREP, 2>(q, kp, vp, bt, lens, out, B, Hkv, L, ps, maxp, scale, st);
    case 4: return launch<D, NREP, 4>(q, kp, vp, bt, lens, out, B, Hkv, L, ps, maxp, scale, st);
    default: return launch<D, NREP, 8>(q, kp, vp, bt, lens, out, B, Hkv, L, ps, maxp, scale, st);
  }
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

template <int D, int NREP, int RPW>
__global__ void __launch_bounds__(flash::WARPS * 32) paged_decode_state(
    const __nv_bfloat16* __restrict__ q,   // [B, Hq, L, D]
    const __nv_bfloat16* __restrict__ kp,  // the shard's pages [p_loc, Hkv, ps, D]
    const __nv_bfloat16* __restrict__ vp,
    const int* __restrict__ bt,    // [B, maxp] global ids, -1 padded
    const int* __restrict__ lens,  // [B] global context lengths
    __nv_bfloat16* __restrict__ out,  // [B, Hq, L, D]
    float* __restrict__ m_out,        // [B, Hq, L]
    float* __restrict__ l_out,
    int Hkv, int L, int ps, int maxp, int base, int p_loc, float scale) {
  const int h = blockIdx.y, bb = blockIdx.z;
  const OwnedPageRows<D> rows{bt + (size_t)bb * maxp, ps, Hkv, h, base, p_loc};
  flash::tile<D, NREP, RPW, true>(q, kp, vp, out, rows, lens[bb], maxp * ps, blockIdx.x, h,
                                        bb, Hkv, L, scale, m_out, l_out);
}

template <int D, int NREP, int RPW>
int launch_decode_state(const void* q, const void* kp, const void* vp, const void* bt,
                        const void* lens, void* out, void* m, void* l, int B, int Hkv, int L,
                        int ps, int maxp, int base, int p_loc, float scale, cudaStream_t st) {
  constexpr int BQ = flash::WARPS * RPW / NREP;
  paged_decode_state<D, NREP, RPW><<<dim3((L + BQ - 1) / BQ, Hkv, B),
                                     dim3(flash::WARPS * 32), 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), static_cast<const int*>(bt),
      static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(out), static_cast<float*>(m),
      static_cast<float*>(l), Hkv, L, ps, maxp, base, p_loc, scale);
  return (int)cudaGetLastError();
}

template <int D, int NREP>
int launch_decode_state_rows(int rpw, const void* q, const void* kp, const void* vp,
                             const void* bt, const void* lens, void* out, void* m, void* l, int B,
                             int Hkv, int L, int ps, int maxp, int base, int p_loc, float scale,
                             cudaStream_t st) {
#define TLT_PDS(RR)                                                                    \
  return launch_decode_state<D, NREP, RR>(q, kp, vp, bt, lens, out, m, l, B, Hkv, L, ps, \
                                          maxp, base, p_loc, scale, st)
  switch (rpw) {
    case 1: TLT_PDS(1);
    case 2: TLT_PDS(2);
    case 4: TLT_PDS(4);
    default: TLT_PDS(8);
  }
#undef TLT_PDS
}

int dispatch(int rpw, const void* q, const void* kp, const void* vp, const void* bt,
             const void* lens, void* out, int B, int Hkv, int L, int ps, int maxp, int D,
             int n_rep, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TLT_PA(DD, RR)                                                                      \
  if (D == DD && n_rep == RR)                                                               \
    return launch_rows<DD, RR>(rpw, q, kp, vp, bt, lens, out, B, Hkv, L, ps, maxp, scale, \
                               st);
  TLT_PA(64, 1) TLT_PA(64, 2) TLT_PA(64, 4) TLT_PA(64, 8)
  TLT_PA(128, 1) TLT_PA(128, 2) TLT_PA(128, 4) TLT_PA(128, 8)
#undef TLT_PA
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// L <= 16: all n_rep * L query rows of a (batch row, KV head) in one block
// when they fit in 64 rows.
extern "C" int tlt_paged_decode(const void* q, const void* kp, const void* vp, const void* bt,
                                const void* lens, void* out, int B, int Hkv, int L, int ps,
                                int maxp, int D, int n_rep, float scale, void* stream) {
  if (L < 1 || L > 16) return (int)cudaErrorInvalidValue;
  const int need = n_rep * L;
  const int rpw = need <= 8 ? 1 : need <= 16 ? 2 : need <= 32 ? 4 : 8;
  return dispatch(rpw, q, kp, vp, bt, lens, out, B, Hkv, L, ps, maxp, D, n_rep, scale, stream);
}

extern "C" int tlt_paged_prefill(const void* q, const void* kp, const void* vp, const void* bt,
                                 const void* lens, void* out, int B, int Hkv, int L, int ps,
                                 int maxp, int D, int n_rep, float scale, void* stream) {
  if (L < 1) return (int)cudaErrorInvalidValue;
  return dispatch(8, q, kp, vp, bt, lens, out, B, Hkv, L, ps, maxp, D, n_rep, scale, stream);
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

// L <= 16 over the shard's pages: rows grouped per block as tlt_paged_decode.
extern "C" int tlt_paged_decode_state(const void* q, const void* kp, const void* vp,
                                      const void* bt, const void* lens, void* out, void* m,
                                      void* l, int B, int Hkv, int L, int ps, int maxp,
                                      int base, int p_loc, int D, int n_rep, float scale,
                                      void* stream) {
  if (L < 1 || L > 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int need = n_rep * L;
  const int rpw = need <= 8 ? 1 : need <= 16 ? 2 : need <= 32 ? 4 : 8;
#define TLT_PDSR(DD, RR)                                                                      \
  if (D == DD && n_rep == RR)                                                                 \
    return launch_decode_state_rows<DD, RR>(rpw, q, kp, vp, bt, lens, out, m, l, B, Hkv, L, \
                                            ps, maxp, base, p_loc, scale, st);
  TLT_PDSR(64, 1) TLT_PDSR(64, 2) TLT_PDSR(64, 4) TLT_PDSR(64, 8)
  TLT_PDSR(128, 1) TLT_PDSR(128, 2) TLT_PDSR(128, 4) TLT_PDSR(128, 8)
#undef TLT_PDSR
  return (int)cudaErrorInvalidValue;
}
