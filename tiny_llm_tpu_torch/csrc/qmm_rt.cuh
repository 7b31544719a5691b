// The any-width matmul body whose group size is a run-time argument, shared
// by the dense and the grouped any-width kernels (quant_matmul_sg.cu,
// moe_matmul_sg.cu) for the widths their templated instances do not cover:
// a group size other than 32, 64 or 128 (any size that divides K, as the
// JAX package's `quantize` takes; 2, 4 or 8 bits).
//
// Weights (ops/quantize.py layout): packed int32 [N, Kp * BITS / 32], 32 /
// BITS consecutive k codes a word; scales/biases bf16 [N, Kp / gsz]; Kp a
// multiple of lcm(128, gsz) (ops/quantize.py k_align), so a group may
// start inside a word when gsz is not a multiple of the codes a word holds.
// out[m, n] = bf16( sum_k x[m, k] * (q[n, k] * s[n, g] + b[n, g]) (+ res) ),
// the dequantized weight fma(q, s, b) in f32 (q * s is exact: the plain
// version's f32 value), f32 accumulation.
//
// Bound on the H100: as the templated routes, the packed weight bytes over
// 3.35 TB/s at decode rows and the bf16 tensor-core rate at prefill rows.
// This body reaches neither: it is the simple SIMT walk that makes every
// width run on the card.
//
// Design: one warp per output column, each lane a word of the column's row
// at a time (lanes on consecutive words, so a warp reads 128 contiguous
// bytes), the word's codes dequantized one by one against the group their
// k falls in, and up to RT_ROWS x rows accumulated a pass over the weights
// (a block's RT_WARPS columns share those rows through L1). The lanes' sums
// meet by shuffles.
#pragma once

#include "common.cuh"

namespace qmm_rt {

constexpr int RT_WARPS = 8;  // output columns a block (256 threads)
constexpr int RT_ROWS = 8;   // x rows a pass over the weights

// acc[r] (r < nrows) += x[r] . dequant(row) for one weight row: wr its
// words, sr / br its group scales and biases, x the first of nrows rows of
// stride Kp. Each lane sums its own words; the caller reduces the warp.
template <int BITS>
__device__ __forceinline__ void walk_row(const __nv_bfloat16* __restrict__ x, int nrows,
                                         const uint32_t* __restrict__ wr,
                                         const __nv_bfloat16* __restrict__ sr,
                                         const __nv_bfloat16* __restrict__ br, int Kp, int gsz,
                                         float (&acc)[RT_ROWS]) {
  constexpr int VPW = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1;
  const int lane = threadIdx.x & 31;
  const int words = Kp / VPW;
  for (int i = lane; i < words; i += 32) {
    const uint32_t word = __ldg(wr + i);
    const int k0 = i * VPW;
    int g = k0 / gsz, g_end = (g + 1) * gsz;
    float sc = bf2f(__ldg(sr + g)), bi = bf2f(__ldg(br + g));
#pragma unroll
    for (int j = 0; j < VPW; ++j) {
      const int k = k0 + j;
      if (k == g_end) {  // the word crosses into the next group
        ++g;
        g_end += gsz;
        sc = bf2f(__ldg(sr + g));
        bi = bf2f(__ldg(br + g));
      }
      const float wv = fmaf(static_cast<float>((word >> (BITS * j)) & MASK), sc, bi);
#pragma unroll
      for (int r = 0; r < RT_ROWS; ++r)
        if (r < nrows) acc[r] = fmaf(bf2f(__ldg(x + (size_t)r * Kp + k)), wv, acc[r]);
    }
  }
}

// The warp's sums of acc, stored by lane 0 as bf16(sum + res) into rows
// [0, nrows) of out (stride N) at column n; res may be null.
__device__ __forceinline__ void store_rows(float (&acc)[RT_ROWS], int nrows,
                                           const __nv_bfloat16* __restrict__ res,
                                           __nv_bfloat16* __restrict__ out, int n, int N) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < RT_ROWS; ++r) {
    if (r >= nrows) break;
    float v = warp_sum(acc[r]);
    if (lane == 0) {
      if (res != nullptr) v += bf2f(res[(size_t)r * N + n]);
      out[(size_t)r * N + n] = __float2bfloat16_rn(v);
    }
  }
}

}  // namespace qmm_rt
