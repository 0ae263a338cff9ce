// 3xTF32 on the tensor cores: the TF32 split and mma.sync.m16n8k8 helpers
// shared by the flash-attention kernels (flash_attention.cu, the forward's
// narrow route; flash_attention_bwd.cu, the backward).
//
// Fragments of mma.sync.m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                     a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 x 8):       c0 / c1 (g, 2t / 2t + 1), c2 / c3 (g + 8, 2t / 2t + 1)
#pragma once

#include <stdint.h>

// TF32 rounding of a finite f32 to nearest, ties away from zero: the
// result of cvt.rna.tf32.f32, whose inf / NaN handling costs three more
// instructions a value (add half an ulp of the 10-bit mantissa to the
// magnitude, clear the 13 bits below it)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32: big = tf32(x), small = tf32(x - big)
__device__ __forceinline__ void split_tf32(float x, uint32_t &big,
                                           uint32_t &small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a b over one m16n8k8 tile, TF32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: d += a_big b_big and dc += a_small b_big + a_big b_small.  The
// small cross terms keep their own accumulator, 2^-11 the size of d's, so
// its truncation costs nothing and d's chain is a third as long.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], float (&dc)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(dc, as, bb);
  mma_tf32(dc, ab, bs);
  mma_tf32(d, ab, bb);
}
