// Tensor-core flash-attention tile for Hopper (sm_90a), emitting each row's
// softmax state: the split paged prefill's two kernels run on it, the
// chunk-state flash prefill (flash_attention.cu, K/V in a dense slab,
// causal) and the paged prefix-state walk (paged_attention.cu, K/V in a page
// pool read through a block table, every prefix key visible to every row).
// Where a key row lives is the `Rows` functor of common.cuh.
//
// What bounds the work on the H100: operations. At 4B's prefix walk (L =
// 1024 over a 7168-token prefix) 120 GFLOP meet 46 MB of q/k/v/o, 0.12 ms
// at the 989 TFLOP/s bf16 peak against 14 us of bytes. A SIMT tile ran
// these products on the FP32 pipes at 2 % of that peak; the TPU kernels
// run them as MXU dots. Here both products run on
// the tensor cores as warpgroup MMAs (wgmma.mma_async, HGMMA in SASS), the
// only route to the card's full bf16 rate:
//
//   * One block of WARPS = 8 warps, two warpgroups, holds BM = 128 query
//     rows: the KV head's NREP query heads times BQ = BM / NREP consecutive
//     positions, so each K/V tile in shared memory serves every head that
//     shares it. Each warpgroup owns 64 rows (wgmma's M), each warp 16.
//   * q * scale is rounded to bf16 once and held in shared memory for the
//     whole walk: S = Q K^T reads both operands by descriptor. (Held as
//     register fragments instead, ptxas of CUDA 12.8 gave P's fragments the
//     registers of Q's at D = 64 and the scores came out wrong; Q in shared
//     memory costs no registers and no such hazard.)
//   * Keys in tiles of BN = 64. K and V tiles move global -> shared with
//     cp.async.cg, 16 bytes a thread, in a STAGES-deep ring, so later tiles
//     load while this one computes. Each 16-byte chunk takes its row from
//     `Rows` (a paged walk looks the page up in the block table, so a tile
//     may straddle pages of any size; -1 entries read the trash page 0).
//     Rows at or past the walk's end are zero-filled (src-size 0) and never
//     read: no Inf or NaN in a trash page can meet a zero p. Nothing at or
//     past `limit` (the slab length, or the block table's width in
//     positions) is read.
//   * Shared tiles are laid out as wgmma's 128-byte swizzle wants them
//     (swz below), so the tensor cores read them without bank conflicts and
//     without padding.
//   * The online softmax runs on the f32 accumulator fragments: row max
//     over a quad with two shuffles, exponentials as ex2 of a fused
//     multiply-add in base 2 (m itself stays in the natural-log domain), row
//     sums kept per thread and summed over the quad once, in the epilogue.
//   * O += P V: P's f32 fragments convert in registers into bf16 A
//     fragments (P never touches shared memory); V is read by descriptor as
//     an MN-major operand.
//   * The walk is software-pipelined: tile t + 1's scores are issued just
//     before tile t's P V, and the warpgroup takes tile t + 1's softmax
//     while the P V runs, so the tensor cores see the two products back to
//     back.
//   * CAUSAL: query i of batch row bb sits at position len - L + i (len may
//     be virtual: below 0, or past the slab) and sees keys at positions <=
//     its own. The walk stops at the q tile's last visible key, the q tiles
//     are issued longest walk first, and only a tile that crosses a row's
//     position or the walk's end is masked element by element. Otherwise
//     every key below min(len, limit) is visible to every row.
//   * MASK (the explicit-mask kernel, flash_attention_masked.cu; the
//     default MASK_NONE leaves the state kernels as they were): non-causal,
//     an additive f32 mask tile of the block's rows moves in the cp.async
//     ring beside each K/V tile, is added to the score fragments and the
//     sum floored at NEG_INF, as the TPU kernels' _flash_inner does. Where
//     four stages of K/V and mask fit (a shared plane at n_rep >= 2, or D =
//     64) the mask rides in the K/V groups; 128 mask rows at D = 128 take
//     three stages of each, the mask copied a step further ahead than K/V
//     (kv_stages). The walk visits only the block's live key tiles: a
//     first kernel marks, per (mask plane, 16-row group, 64-key tile),
//     whether any entry below L and the row's length exceeds NEG_INF
//     (flash_attention_masked.cu mask_tile_map); the block ORs its groups
//     and planes into a list of live tiles in its prologue, and the ring's
//     stages follow the position in that list. A skipped tile is exact:
//     every score of it would be NEG_INF, so m, l and acc stay as they are.
//     p is then ex2((s - m) log2 e), not an FMA of s log2 e: a row whose
//     mask is -1e29 everywhere keeps s = m exactly and averages V, where
//     the FMA's rounding of m log2 e alone would reach 1e21.
//   * STATE = false (the masked kernel, the paged prefill): q arrives by
//     cp.async in a group of its own, first, and is scaled in place; o
//     alone is written, staged through shared memory into 16-byte stores
//     (a block's fixed cost weighs on the masked walk's short, sparse
//     walks).
//   * SPLIT (the paged prefill's key split, with STATE = false): `rows`,
//     `len` and `limit` describe one split of the keys, its positions
//     counted from the split's first key, and the block writes its f32
//     partial per row (acc before the division, m, l) into a workspace for
//     a combine kernel; a block none of whose rows sees a key of the split
//     exits at once.
//
// Rounding points are those of the TPU kernels' _flash_inner (and of
// split_walk.cuh): q * scale rounds to bf16, scores and the softmax state are
// f32, p rounds to bf16 for the PV product, o = acc / max(l, 1e-30) rounds
// to bf16, NEG_INF / 2 floors the subtrahend. The epilogue writes o and
// each row's m (max scaled score) and l (sum of the f32 p) as f32
// [B, Hq, L]; a row that sees no key emits exactly (0, NEG_INF, 0), and
// padding rows past L write nothing.
#pragma once

#include "common.cuh"

namespace fmma {

constexpr int WARPS = 8, BN = 64, STAGES = 4;
constexpr float LOG2E = 1.4426950408889634f;

using ::cp_async16, ::cp_async4, ::cp_async_commit, ::cp_async_wait, ::smem_u32;  // common.cuh

// Warpgroup MMAs. D (64 x N, f32) lives in registers, d[4j + e] holding
// rows g (e < 2) and g + 8 of each warp's 16 (g = lane / 4), columns 8j +
// 2 (lane % 4) + (e & 1). A (64 x 16 bf16) comes from shared memory by
// descriptor or from registers in the mma.sync A-fragment layout (each
// warp its 16 rows); B (16 x N) from shared memory by descriptor.
// D (64 x 64) = / += A B with both operands in shared memory by descriptor,
// both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x N) += A B, A from registers, B MN-major (V: d contiguous).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Registers a wgmma reads are written before its wgmma.fence, and those it
// writes are read after its wait: an empty asm over each register is that
// barrier to the compiler.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}
// Shared memory written through the generic proxy (cp.async, st.shared) is
// read by wgmma through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A 128-byte-swizzled shared matrix descriptor: start address, the strides
// between 64-element column blocks (lbo) and between 8-row groups (sbo).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr >> 4) & 0x3FFF) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte offset of 16-byte chunk c of row r in a [ROWS][D] bf16 tile laid out
// as wgmma's 128-byte swizzle wants it: 64-element column blocks of ROWS
// rows of 128 bytes, chunk c % 8 of row r stored at (c % 8) ^ (r & 7). Tiles
// start 1024-byte aligned, so the hardware's swizzle (address bits 4-6 XOR
// bits 7-9) is this one. K-major operands (Q, K: d contiguous) step 32
// bytes along a row a k16 step; V, MN-major, steps 16 rows.
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>((c >> 3) * ROWS * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// The rings of a walk with MR mask rows a tile (0: no mask). The mask
// tile rides in the K/V ring's groups, STAGES deep, where both fit in
// shared memory (a shared plane at n_rep >= 2, or D = 64); otherwise (128
// rows at D = 128) K/V and the mask take three stages each and the mask is
// copied a step further ahead than K/V: the mask streams from device memory
// (128 MB of per-head planes at 4B's heads), K/V mostly from L2.
template <int D, int MR>
__host__ __device__ constexpr int kv_stages() {
  return MR == 0 || STAGES * (2 * BN * D * 2 + MR * BN * 4) + WARPS * 16 * D * 2 + 1024 <=
                        227 * 1024
             ? STAGES
             : 3;
}

// Dynamic shared memory of one block: the ring of K and V tiles, then q,
// then the ring of mask tiles. Above 48 KB, so each kernel sets
// cudaFuncAttributeMaxDynamicSharedMemorySize before its first launch.
template <int D, int MR = 0>
constexpr int smem_bytes() {
  return kv_stages<D, MR>() * (2 * BN * D * 2 + MR * BN * 4) + WARPS * 16 * D * 2 +
         1024;  // + slack to align to 1024
}

// Explicit additive masks. MASK_SHARED: one [L, S] f32 plane per batch row,
// every head alike; MASK_HEAD: one plane per query head. Plane p of batch
// row bb starts at mask + bb * msb + p * msh; rows are contiguous (row
// stride S).
constexpr int MASK_NONE = 0, MASK_SHARED = 1, MASK_HEAD = 2;

struct MaskPlanes {
  const float* mask;
  long long msb, msh;  // batch and head strides, elements
  int S;               // a plane's row stride and key count
  bool vec;            // planes, rows and strides 16-byte aligned: 16-byte copies
  uint8_t* map;        // the live-tile map [B, P, G, NT] (mask_tile_map)
  int planes, groups, ntk;  // P, G = ceil(L / 16), NT = ceil(S / 64)
  int* list;                // the block's own list of live key tiles (workspace)
};

// A mask tile in shared memory: MR rows of BN f32, 16-byte chunk c of row r
// at chunk c ^ 2 (r & 7), so the eight rows of a fragment read (rows g,
// columns 2 tig + 8j) hit distinct banks.
__device__ __forceinline__ uint32_t mswz(int r, int c) {
  return static_cast<uint32_t>(r * BN * 4 + ((c ^ ((r & 7) << 1)) << 4));
}

// Copy key tile t (keys t * BN ..) of MR mask rows into a ring stage at ms;
// rowp(r) is row r's start in its plane (nullptr: a padding row, zeros).
// Keys at or past S are zero-filled: the walk masks them anyway.
template <int MR, int THREADS, class RowPtr>
__device__ __forceinline__ void load_mask_tile(uint32_t ms, const MaskPlanes& mp, int t, int tid,
                                               RowPtr rowp) {
  if (mp.vec) {
    for (int i = tid; i < MR * BN / 4; i += THREADS) {
      const int r = i / (BN / 4), c = i % (BN / 4), key = t * BN + 4 * c;
      const float* src = rowp(r);
      const bool ok = src != nullptr && key < mp.S;
      cp_async16(ms + mswz(r, c), ok ? src + key : mp.mask, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < MR * BN; i += THREADS) {
      const int r = i / BN, e = i % BN, key = t * BN + e;
      const float* src = rowp(r);
      const bool ok = src != nullptr && key < mp.S;
      cp_async4(ms + mswz(r, e >> 2) + (e & 3) * 4, ok ? src + key : mp.mask, ok ? 4 : 0);
    }
  }
}

// Add a mask tile's values (at ms, generic) to NJ 8-column score fragments
// of rows mr[0] and mr[1] (s[4j + e]: row mr[e >> 1], column c0 + 8j + 2 tig
// + (e & 1)), the sums floored at NEG_INF.
template <int NJ>
__device__ __forceinline__ void add_mask(float (&s)[4 * NJ], const uint8_t* ms, const int (&mr)[2],
                                         int c0, int tig) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = c0 + 8 * j + 2 * tig;
      const float2 mk =
          *reinterpret_cast<const float2*>(ms + mswz(mr[hh], col >> 2) + (col & 3) * 4);
      s[4 * j + 2 * hh] = fmaxf(s[4 * j + 2 * hh] + mk.x, TLT_NEG_INF);
      s[4 * j + 2 * hh + 1] = fmaxf(s[4 * j + 2 * hh + 1] + mk.y, TLT_NEG_INF);
    }
}

// The masked walk's prologue: the block's live key tiles below ntiles,
// ascending, into mp.list; returns their count. A tile is live when the
// map marks it for any plane and 16-row group of the block's rows (BQ
// positions from q0, and for MASK_HEAD the KV head's NREP query heads).
template <int NREP, int MASK, int BQ>
__device__ __forceinline__ int live_tiles(const MaskPlanes& mp, int ntiles, int bb, int h,
                                          int q0, int L, int tid) {
  constexpr int THREADS = WARPS * 32, NP = MASK == MASK_HEAD ? NREP : 1;
  __shared__ int wcnt[WARPS];
  const int lane = tid & 31, warp = tid >> 5;
  const int g0 = q0 / 16, g1 = (min(q0 + BQ, L) - 1) / 16;
  const uint8_t* map =
      mp.map + ((size_t)bb * mp.planes + (MASK == MASK_HEAD ? h * NREP : 0)) * mp.groups * mp.ntk;
  int n = 0;
  for (int base = 0; base < ntiles; base += THREADS) {
    const int t = base + tid;
    bool on = false;
    if (t < ntiles)
      for (int p = 0; p < NP; ++p)
        for (int g = g0; g <= g1; ++g) on |= __ldg(map + ((size_t)p * mp.groups + g) * mp.ntk + t);
    const unsigned bal = __ballot_sync(0xffffffffu, on);
    if (lane == 0) wcnt[warp] = __popc(bal);
    __syncthreads();
    int at = n;
    for (int w = 0; w < WARPS; ++w) {
      at += w < warp ? wcnt[w] : 0;
      n += wcnt[w];
    }
    if (on) mp.list[at + __popc(bal & ((1u << lane) - 1))] = t;
    __syncthreads();  // the list is written; wcnt may be reused
  }
  return n;
}

// Issue S = Q K^T for the warpgroup's 64 rows (q at qa) and one key tile
// (K at ka): KS k16 steps, one commit group.
template <int KS>
__device__ __forceinline__ void issue_qk(float (&s)[BN / 2], uint32_t qa, uint32_t ka) {
  constexpr int BM = WARPS * 16;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_ss_n64(s, sw128_desc(qa + (kk >> 2) * BM * 128 + (kk & 3) * 32, 0, 1024),
                 sw128_desc(ka + (kk >> 2) * BN * 128 + (kk & 3) * 32, 0, 1024), kk > 0);
  wgmma_commit();
}

// Issue O += P V for one key tile (V at va): BN / 16 k16 steps, one commit
// group.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], uint32_t (&pa)[BN / 16][4],
                                         uint32_t va) {
  fence_regs(acc);
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < BN / 16; ++kt) {
    const uint64_t vd = sw128_desc(va + kt * 16 * 128, BN * 128, 1024);
    if constexpr (D == 64) wgmma_rs_n64(acc, pa[kt], vd, 1);
    else wgmma_rs_n128(acc, pa[kt], vd, 1);
  }
  wgmma_commit();
}

// The online softmax of one key tile (keys t0 .. t0 + BN - 1) on its score
// fragments, rows g (i & 2 == 0) and g + 8: masks the keys a row may not
// see (only on a tile that crosses the walk's end or a row's position),
// updates m and l, writes P as bf16 A fragments and the factors that
// rescale the rows' earlier sums. EXACT (the masked walk): p = ex2((s - m)
// log2 e), exact where s = m at any magnitude.
template <bool CAUSAL, bool EXACT = false>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], uint32_t (&pa)[BN / 16][4],
                                             float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             int t0, int kend, int qmin, const int (&qpos)[2],
                                             int tig) {
  if (t0 + BN > kend || (CAUSAL && t0 + BN - 1 > qmin)) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int kpos = t0 + 8 * (i >> 2) + 2 * tig + (i & 1);
      const bool seen = kpos < kend && (!CAUSAL || kpos <= qpos[(i >> 1) & 1]);
      if (!seen) s[i] = TLT_NEG_INF;
    }
  }
  float mf[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = m[hh];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[hh] = ex2((m[hh] - mx) * LOG2E);
    if constexpr (EXACT) mf[hh] = fmaxf(mx, TLT_NEG_INF / 2);
    else mf[hh] = fmaxf(mx, TLT_NEG_INF / 2) * LOG2E;
    m[hh] = mx;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (EXACT) p[e] = ex2((s[4 * j + e] - mf[e >> 1]) * LOG2E);
      else p[e] = ex2(fmaf(s[4 * j + e], LOG2E, -mf[e >> 1]));
      rs[e >> 1] += p[e];
    }
    pa[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + rs[hh];
}

// Mask rows of one tile in the masked walk: the block's BQ positions for a
// shared plane, every one of its BM rows for per-head planes.
template <int NREP, int MASK>
__host__ __device__ constexpr int mask_rows() {
  return MASK == MASK_NONE ? 0 : MASK == MASK_HEAD ? WARPS * 16 : WARPS * 16 / NREP;
}

// A block's key split (SPLIT): its partials go to ws_o [splits, B, Hq, L,
// D] and ws_ml [splits, B, Hq, L, 2], f32, at split `split`.
struct KeySplit {
  float* ws_o;
  float* ws_ml;
  int split, B;
};

template <int D, int NREP, bool CAUSAL, class Rows, int MASK = MASK_NONE, bool STATE = true,
          bool SPLIT = false>
__device__ __forceinline__ void state_tile(
    const __nv_bfloat16* __restrict__ q,  // [B, Hq, L, D]
    const __nv_bfloat16* __restrict__ k,  // base of the rows `rows` addresses
    const __nv_bfloat16* __restrict__ v,
    __nv_bfloat16* __restrict__ out,  // [B, Hq, L, D]
    float* __restrict__ m_out,        // [B, Hq, L] (STATE)
    float* __restrict__ l_out,
    const Rows rows, int len, int limit, int qt, int h, int bb, int Hkv, int L, float scale,
    const MaskPlanes mp = MaskPlanes{}, const KeySplit ks = KeySplit{}) {
  constexpr bool MASKED = MASK != MASK_NONE;
  static_assert(!(MASKED && CAUSAL), "an explicit mask replaces causality");
  static_assert(!(SPLIT && (STATE || MASKED)), "a key split writes partials, unmasked");
  constexpr int THREADS = WARPS * 32, BM = 16 * WARPS, BQ = BM / NREP;
  constexpr int MR = mask_rows<NREP, MASK>();   // mask rows of a tile
  constexpr int MTILE = MR * BN * 4;            // bytes of one mask tile
  constexpr int CH = D / 8;                     // 16-byte chunks in a row
  constexpr int TILE = BN * D * 2;              // bytes of one K or V tile
  constexpr int KV_CHUNKS = BN * CH / THREADS;  // a thread's chunks of one tile
  static_assert(BM % NREP == 0, "a q tile holds whole query heads");
  constexpr int KST = kv_stages<D, MR>();  // ring stages (the mask's as many)
  static_assert(KST >= 3 && STAGES == 4, "tile t + 1 lands while tile t computes");
  static_assert((BN * CH) % THREADS == 0 && (BM * CH) % THREADS == 0, "whole chunks a thread");
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sraw = smem_u32(smem), sbase = (sraw + 1023) & ~1023u;
  const uint32_t qbase = sbase + KST * 2 * TILE;
  const uint32_t mbase = qbase + BM * D * 2;  // MASKED: the ring of mask tiles

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int Hq = Hkv * NREP;
  const int q0 = qt * BQ;

  // The keys this block may read, and where its walk ends.
  const int kend = min(len, limit);
  const int walk = CAUSAL ? min(kend, len - L + min(q0 + BQ, L)) : kend;
  const int ntiles = walk > 0 ? (walk + BN - 1) / BN : 0;
  const int qmin = len - L + q0;  // CAUSAL: the block's first row position
  if constexpr (SPLIT)
    if (ntiles == 0) return;  // no row of the block sees a key of the split

  // !STATE (the masked entry): q copied raw by cp.async in a group of its
  // own, ahead of everything, and scaled in place once it lands; its
  // latency hides under the list's and the first tiles'.
  if constexpr (!STATE) {
#pragma unroll
    for (int i = 0; i < BM * CH / THREADS; ++i) {
      const int idx = tid + i * THREADS, rr = idx / CH, c = idx % CH;
      const int rep = rr / BQ, qi = q0 + rr % BQ;
      const size_t o = qi < L ? (((size_t)bb * Hq + h * NREP + rep) * L + qi) * D + c * 8 : 0;
      cp_async16(qbase + swz<BM>(rr, c), q + o, qi < L ? 16 : 0);
    }
    cp_async_commit();
  }

  // MASKED: the walk visits the live tiles of the list, whose i-th entry
  // is key tile tile_of(i); ring stages follow i. Otherwise tile i itself.
  int nwalk = ntiles;
  if constexpr (MASKED) nwalk = live_tiles<NREP, MASK, BQ>(mp, ntiles, bb, h, q0, L, tid);
  auto tile_of = [&](int i) {
    if constexpr (MASKED) return mp.list[i];
    else return i;
  };
  // Mask row r of a tile: its row's start in its plane (nullptr past L).
  auto mask_row = [&](int r) -> const float* {
    const int qi = q0 + r % BQ;
    const long long plane = MASK == MASK_HEAD ? (long long)(h * NREP + r / BQ) * mp.msh : 0;
    return qi < L ? mp.mask + bb * mp.msb + plane + (long long)qi * mp.S : nullptr;
  };

  // Live position i's K and V tiles (key tile t) into its stage.
  auto load_tile = [&](int i, int t) {
    const uint32_t ks = sbase + (i % KST) * 2 * TILE, vs = ks + TILE;
#pragma unroll
    for (int j = 0; j < KV_CHUNKS; ++j) {
      const int idx = tid + j * THREADS, r = idx / CH, c = idx % CH;
      const int pos = t * BN + r;
      const bool ok = pos < walk;
      const size_t o = ok ? rows(pos) + c * 8 : 0;
      cp_async16(ks + swz<BN>(r, c), k + o, ok ? 16 : 0);
      cp_async16(vs + swz<BN>(r, c), v + o, ok ? 16 : 0);
    }
  };
  // MASKED: live position i's mask tile (key tile t) into its stage.
  auto load_mask = [&](int i, int t) {
    load_mask_tile<MR, THREADS>(mbase + (i % KST) * MTILE, mp, t, tid, mask_row);
  };
  auto stage = [&](int i) { return sbase + (i % KST) * 2 * TILE; };

  // Groups 0, 1, 2: K/V (below KST - 1) and the mask of positions 0, 1, 2.
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nwalk) {
      if (i < KST - 1) load_tile(i, tile_of(i));
      if constexpr (MASKED) load_mask(i, tile_of(i));
    }
    cp_async_commit();
  }

  // q * scale, rounded to bf16, into shared memory: row rr = rep * BQ +
  // (qi - q0); rows past L are zeros.
  uint8_t* qs = smem + (qbase - sraw);
  if constexpr (STATE) {
#pragma unroll
    for (int i = 0; i < BM * CH / THREADS; ++i) {
      const int idx = tid + i * THREADS, rr = idx / CH, c = idx % CH;
      const int rep = rr / BQ, qi = q0 + rr % BQ;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (qi < L)
        raw = __ldg(reinterpret_cast<const uint4*>(
                        q + (((size_t)bb * Hq + h * NREP + rep) * L + qi) * D) + c);
      uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = pack_bf16(lo_bf16(w[j]) * scale, hi_bf16(w[j]) * scale);
      *reinterpret_cast<uint4*>(qs + swz<BM>(rr, c)) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  const uint32_t qa = qbase + (warp >> 2) * 64 * 128;  // the warpgroup's 64 rows

  // This thread's two rows (g and g + 8 of the warp's 16): their positions
  // and (MASKED) their rows of a mask tile.
  int qpos[2], mr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rr = warp * 16 + g + 8 * hh;
    qpos[hh] = len - L + q0 + rr % BQ;
    mr[hh] = MASK == MASK_HEAD ? rr : rr % BQ;
  }
  // MASKED: add live position i's mask tile to the scores.
  auto masked = [&](float(&sc)[BN / 2], int i) {
    if constexpr (MASKED)
      add_mask<BN / 8>(sc, smem + (mbase + (i % KST) * MTILE - sraw), mr, 0, tig);
  };
  float m[2] = {TLT_NEG_INF, TLT_NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[BN / 2];
  uint32_t pa[BN / 16][4];  // P as bf16 A fragments, one per 16 keys

  // Tile 0's scores and softmax (acc is still 0: nothing to rescale).
  cp_async_wait<STAGES - 2>();
  if constexpr (!STATE) {  // this thread's q chunks landed: scale them
#pragma unroll
    for (int i = 0; i < BM * CH / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      uint4* p = reinterpret_cast<uint4*>(qs + swz<BM>(idx / CH, idx % CH));
      uint32_t w[4] = {p->x, p->y, p->z, p->w};
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = pack_bf16(lo_bf16(w[j]) * scale, hi_bf16(w[j]) * scale);
      *p = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  fence_proxy_async();
  __syncthreads();  // tile 0 and q landed for every thread
  if (nwalk > 0) {
    issue_qk<D / 16>(s, qa, stage(0));
    wgmma_wait<0>();
    fence_regs(s);
    masked(s, 0);
    softmax_tile<CAUSAL, MASKED>(s, pa, m, l, alpha, tile_of(0) * BN, kend, qmin, qpos, tig);
  }
  // Step t: tile t + 1's scores, then tile t's P V; tile t + 1's softmax
  // while the P V runs. Each step copies the K/V of position t + KST - 1
  // and (MASKED) the mask of position t + 3; with three K/V stages the K/V
  // group is committed first, so the wait at step t + 1 covers it while the
  // mask of t + 3 stays in flight. MASKED: the list entries the copies need
  // are read a step ahead.
  int t_kv = 0, t_mask = 0, t1 = 0;
  auto tile_at = [&](int i) { return i < nwalk ? tile_of(i) : 0; };
  if constexpr (MASKED) {
    t_kv = tile_at(KST - 1);
    t_mask = tile_at(STAGES - 1);
  }
  for (int t = 0; t + 1 < nwalk; ++t) {
    cp_async_wait<STAGES - 3>();
    fence_proxy_async();
    __syncthreads();  // tile t + 1 landed for every thread; tile t - 1's stage is free
    if (t + KST - 1 < nwalk) load_tile(t + KST - 1, MASKED ? t_kv : tile_of(t + KST - 1));
    if constexpr (MASKED) {
      if constexpr (KST < STAGES) cp_async_commit();
      if (t + STAGES - 1 < nwalk) load_mask(t + STAGES - 1, t_mask);
    }
    cp_async_commit();
    if constexpr (MASKED) {
      t1 = tile_of(t + 1);
      const int t4 = tile_at(t + STAGES);  // position t + 4: the next step's mask
      t_kv = KST < STAGES ? t_mask : t4;
      t_mask = t4;
    }
    issue_qk<D / 16>(s, qa, stage(t + 1));
    issue_pv<D>(acc, pa, stage(t) + TILE);
    wgmma_wait<1>();  // the scores
    fence_regs(s);
    masked(s, t + 1);
    uint32_t pn[BN / 16][4];
    softmax_tile<CAUSAL, MASKED>(s, pn, m, l, alpha, (MASKED ? t1 : t + 1) * BN, kend, qmin,
                                 qpos, tig);
    wgmma_wait<0>();  // the P V
    fence_regs(acc);
    fence_regs(pa);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < BN / 16; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[i][j] = pn[i][j];
  }
  if (nwalk > 0) {
    issue_pv<D>(acc, pa, stage(nwalk - 1) + TILE);
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // SPLIT: the split's partial of each row below L, as it stands.
  if constexpr (SPLIT) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      const int rr = warp * 16 + g + 8 * hh;
      const int rep = rr / BQ, qi = q0 + rr % BQ;
      if (qi >= L) continue;
      const size_t row = (((size_t)ks.split * ks.B + bb) * Hq + h * NREP + rep) * L + qi;
      float* o = ks.ws_o + row * D + 2 * tig;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(o + 8 * j) = make_float2(acc[4 * j + 2 * hh],
                                                            acc[4 * j + 2 * hh + 1]);
      if (tig == 0) {
        ks.ws_ml[2 * row] = m[hh];
        ks.ws_ml[2 * row + 1] = l[hh];
      }
    }
    return;
  }

  // Epilogue: the quad's row sums, o = acc / max(l, 1e-30), m and l.
  // !STATE: o goes through shared memory (the q tile: each warpgroup's
  // wgmmas, the only readers of its 64 rows, have completed), then out in
  // 16-byte stores, whole rows a warp.
  if constexpr (!STATE) {
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      const int rr = warp * 16 + g + 8 * hh;
      const float inv = 1.f / fmaxf(l[hh], 1e-30f);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(qs + swz<BM>(rr, j) + 4 * tig) =
            pack_bf16(acc[4 * j + 2 * hh] * inv, acc[4 * j + 2 * hh + 1] * inv);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < BM * CH / THREADS; ++i) {
      const int idx = tid + i * THREADS, rr = idx / CH, c = idx % CH;
      const int rep = rr / BQ, qi = q0 + rr % BQ;
      const size_t row = ((size_t)bb * Hq + h * NREP + rep) * L + qi;
      if (qi < L)
        *reinterpret_cast<uint4*>(out + row * D + c * 8) =
            *reinterpret_cast<const uint4*>(qs + swz<BM>(rr, c));
    }
    return;
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int rr = warp * 16 + g + 8 * hh;
    const int rep = rr / BQ, qi = q0 + rr % BQ;
    if (qi >= L) continue;
    const size_t row = ((size_t)bb * Hq + h * NREP + rep) * L + qi;
    const float inv = 1.f / fmaxf(l[hh], 1e-30f);
    uint32_t* o = reinterpret_cast<uint32_t*>(out + row * D) + tig;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      o[j * 4] = pack_bf16(acc[4 * j + 2 * hh] * inv, acc[4 * j + 2 * hh + 1] * inv);
    if (tig == 0) {
      m_out[row] = m[hh];
      l_out[row] = l[hh];
    }
  }
}

}  // namespace fmma
