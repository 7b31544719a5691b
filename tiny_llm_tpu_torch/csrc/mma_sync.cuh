// mma.sync building blocks of the split-key decode walks (the masked decode
// walk of flash_attention_masked.cu and the paged decode-state walk of
// paged_attention.cu): K and V rows in shared memory with their 16-byte
// chunks XOR-swizzled, read by ldmatrix into m16n8k16 bf16 fragments.
#pragma once

#include "common.cuh"

// Byte offset of 16-byte chunk c of row r in rows of D bf16, chunk c stored
// at c ^ (r & 7): the eight rows of an ldmatrix read hit distinct banks.
template <int D>
__device__ __forceinline__ uint32_t rswz(int r, int c) {
  return static_cast<uint32_t>(r * D * 2 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d (16 x 8, f32) += a (16 x 16 bf16, row) b (16 x 8 bf16, col). Fragments:
// d[0..1] row g, columns 2 tig + {0, 1}; d[2..3] row g + 8.
__device__ __forceinline__ void mma16816(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
