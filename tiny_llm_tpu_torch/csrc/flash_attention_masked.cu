// Flash attention over dense K/V with an explicit additive mask, for Hopper
// (sm_90a): tlt_flash_attention_masked.
//
// Replaces tiny_llm_tpu/kernels/flash_attention_pallas.py::
// _decode_kernel_masked (L <= 16, through _flash_decode) and
// ::_prefill_kernel_masked (L > 16, through _flash_prefill), both reached
// from flash_attention_pallas(mask=<array>): one kernel for any L >= 1, as
// K3 covers the two causal kernels. The mask replaces causality: every
// query row of batch row b sits at position lens[b] - 1, so only the
// length bounds the keys, and the f32 mask value is added to each visible
// key's score after that clamp (sum floored at -1e30). A row that sees no
// key emits 0, not NaN. Mask layouts (flash_tile.cuh's MASK option):
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
// per plane) over 3.35 TB/s, or 4 * Hq * L * lens * D operations over the
// bf16 peak. At decode (L <= 16) the K/V and the mask set it; a per-head
// prefill mask (32 planes of 1024 x 1024 at Qwen3-4B's heads: 128 MB)
// dominates every other byte. The tile reads each mask element once, one
// coalesced 128-byte row segment per warp row and 32-key tile.
//
// Design: flash_tile.cuh with CAUSAL = false and the MASK option, one
// block per (q tile, kv head, batch row). The block holds 8 * RPW query
// rows, RPW the least of 1, 2, 4, 8 whose rows hold all n_rep * L rows of
// a KV head (the decode-shaped rows of the shard decode-state kernel), 8
// for longer L. Mode 0 has the 64-row tile only (it is no path's hot
// route). SIMT only, as K3: tensor cores are later work.
#include "flash_tile.cuh"

namespace {

template <int D, int NREP, int RPW, int MASK>
__global__ void __launch_bounds__(flash::WARPS * 32) flash_masked(
    const __nv_bfloat16* __restrict__ q,  // [B, Hq, L, D]
    const __nv_bfloat16* __restrict__ k,  // [B, Hkv, S, D]
    const __nv_bfloat16* __restrict__ v,
    const int* __restrict__ lens,  // [B]
    const float* __restrict__ mask,  // planes of [L, S] f32 (mode 0: unused)
    __nv_bfloat16* __restrict__ out,  // [B, Hq, L, D]
    int Hkv, int L, int S, long long msb, long long msh, float scale) {
  const int h = blockIdx.y, bb = blockIdx.z;
  const SlabRows<D> rows{((size_t)bb * Hkv + h) * (size_t)S * D};
  flash::tile<D, NREP, RPW, false, false, MASK>(q, k, v, out, rows, lens[bb], S, blockIdx.x, h,
                                                bb, Hkv, L, scale, nullptr, nullptr, mask, msb,
                                                msh, S);
}

template <int D, int NREP, int RPW, int MASK>
int launch(const void* q, const void* k, const void* v, const void* lens, const void* mask,
           void* out, int B, int Hkv, int L, int S, long long msb, long long msh, float scale,
           cudaStream_t st) {
  constexpr int BQ = flash::WARPS * RPW / NREP;
  flash_masked<D, NREP, RPW, MASK><<<dim3((L + BQ - 1) / BQ, Hkv, B),
                                     dim3(flash::WARPS * 32), 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lens),
      static_cast<const float*>(mask), static_cast<__nv_bfloat16*>(out), Hkv, L, S, msb, msh,
      scale);
  return (int)cudaGetLastError();
}

template <int D, int NREP, int MASK>
int launch_rows(int rpw, const void* q, const void* k, const void* v, const void* lens,
                const void* mask, void* out, int B, int Hkv, int L, int S, long long msb,
                long long msh, float scale, cudaStream_t st) {
#define TLT_MR(RR) \
  return launch<D, NREP, RR, MASK>(q, k, v, lens, mask, out, B, Hkv, L, S, msb, msh, scale, st)
  switch (rpw) {
    case 1: TLT_MR(1);
    case 2: TLT_MR(2);
    case 4: TLT_MR(4);
    default: TLT_MR(8);
  }
#undef TLT_MR
}

template <int D, int NREP>
int dispatch(int mode, int rpw, const void* q, const void* k, const void* v, const void* lens,
             const void* mask, void* out, int B, int Hkv, int L, int S, long long msb,
             long long msh, float scale, cudaStream_t st) {
  switch (mode) {
    case 0:
      return launch<D, NREP, 8, flash::MASK_NONE>(q, k, v, lens, mask, out, B, Hkv, L, S, 0,
                                                  0, scale, st);
    case 1:
      return launch_rows<D, NREP, flash::MASK_SHARED>(rpw, q, k, v, lens, mask, out, B, Hkv, L,
                                                      S, msb, msh, scale, st);
    case 2:
      return launch_rows<D, NREP, flash::MASK_HEAD>(rpw, q, k, v, lens, mask, out, B, Hkv, L, S,
                                                    msb, msh, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// mode: 0 none, 1 shared, 2 per head (see above).
extern "C" int tlt_flash_attention_masked(const void* q, const void* k, const void* v,
                                          const void* lens, const void* mask, void* out, int B,
                                          int Hkv, int L, int S, int D, int n_rep, int mode,
                                          long long msb, long long msh, float scale,
                                          void* stream) {
  if (L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int need = n_rep * L;
  const int rpw = need <= 8 ? 1 : need <= 16 ? 2 : need <= 32 ? 4 : 8;
#define TLT_KM(DD, RR)                                                                       \
  if (D == DD && n_rep == RR)                                                                \
    return dispatch<DD, RR>(mode, rpw, q, k, v, lens, mask, out, B, Hkv, L, S, msb, msh,   \
                            scale, st);
  TLT_KM(64, 1) TLT_KM(64, 2) TLT_KM(64, 4) TLT_KM(64, 8)
  TLT_KM(128, 1) TLT_KM(128, 2) TLT_KM(128, 4) TLT_KM(128, 8)
#undef TLT_KM
  return (int)cudaErrorInvalidValue;
}
