// The k-order of a bf16 conv output on the tensor cores, shared by the
// per-layer conv kernel (trim_conv2d.cu, route "mma") and the fused-group
// kernel (trim_conv2d_fused.cu, its stages on route "mma").  The weight
// gradient's route "mma" (trim_conv2d_wgrad.cu) and the flash kernel's
// bf16 narrow route (flash_attention.cu) use the loaders and the
// instruction below in k-orders of their own, each stated in its file.
//
// Contract.  On a layer whose Cin/g is a multiple of 16 (core/conv_plan.py,
// bf16_route), each bf16 output element y[n, oh, ow, co] is
//
//   acc = 0.0f                                   (one f32 accumulator)
//   for (ki, kj) in row-major order over the KH x KW taps:
//     for ci0 = 0, 16, ..., Cin/g - 16:          (ascending runs of 16)
//       acc = mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32(
//                 A, B, acc)                     (one k-step)
//   v = acc + bias        (a separate f32 add, where there is a bias)
//   v = activate(v)       (epilogue.cuh)
//   y = __float2bfloat16_rn(v)                   (the one rounding)
//
// where k lane l of A is x at tap (ki, kj) and channel ci0 + l, and k lane l
// of B is w[ki, kj, ci0 + l, co], l = 0..15 in that order.  Products of two
// bf16 values are exact; the tensor core adds the 16 of a k-step and acc in
// its own fixed way.  Nothing else enters an element's sum: no split of the
// k axis across warps or blocks, no other mma shape, no other order.  So
// the result depends on nothing but the element -- not on the batch, the
// dataflow (carry or halo), the tile, the ring depth, the warp layout, the
// position of the element in its fragment, or the group it is fused in --
// and carry == halo, fused == the per-layer chain and a served row ==
// forward_one hold bit for bit on the card.  This header holds the loop
// that takes the k-steps (bf16_mma_steps), the cursor that walks them
// (KStep) and the instruction; both kernels load their fragments their own
// way and call these.
//
// Fragments of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4), each
// register two bf16 values, the lower k first:
//   A (16 x 16, row): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t+8..),
//                     a3 (g + 8, 2t+8..)
//   B (16 x 8, col):  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C (16 x 8, f32):  c0 / c1 (g, 2t / 2t+1), c2 / c3 (g + 8, 2t / 2t+1)
// A comes by ldmatrix.x4 from rows of 8 channels (lane l gives the address
// of row (l & 7) + 8 ((l >> 3) & 1), channels 8 (l >> 4) on); B by
// ldmatrix.x4.trans from k-major rows of output channels (lane l: k row
// (l & 7) + 8 ((l >> 3) & 1), channels 8 (l >> 4) on: the b0 / b1 pairs of
// two n8 fragments).
#pragma once

#include <stdint.h>

constexpr int kBf16MmaM = 16;      // positions of one A fragment
constexpr int kBf16MmaN = 8;       // output channels of one C fragment
constexpr int kBf16MmaK = 16;      // input channels of one k-step
constexpr int kBf16WarpN = 32;     // output channels a warp: 4 n8 fragments
constexpr int kBf16RowPad = 8;     // bf16 past each k-major weight row (one
                                   // 16-byte quad: an odd count of quads)
constexpr int kBf16FusedMFrags = 4;  // m16 fragments a warp in a fused
                                     // stage (trim_conv2d_fused.cu) ...
constexpr int kBf16FusedChunk = 64;  // ... (tap, channel) rows of one of
constexpr int kBf16FusedRingSlots = 2;  // its weight ring's slots

__device__ __forceinline__ uint32_t bf16_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8 x 8 b16 matrices: A's four registers, rows from the lanes.
__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(bf16_smem_addr(p)));
}

// The same, transposed: (b0, b1) of two n8 fragments from k-major rows.
__device__ __forceinline__ void ldsm_x4_trans(const void* p,
                                              uint32_t (&b)[2],
                                              uint32_t (&c)[2]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(c[0]), "=r"(c[1])
      : "r"(bf16_smem_addr(p)));
}

// An A fragment from k-major rows (A^T stored row by row, the weight
// gradient's position-major x stage): lane l gives the address of k row
// (l & 7) + 8 (l >> 4), m columns 8 ((l >> 3) & 1) on, so the four
// transposed 8 x 8 matrices land as a0 (m 0-7, k 0-7), a1 (m 8-15, k 0-7),
// a2 (m 0-7, k 8-15), a3 (m 8-15, k 8-15).
__device__ __forceinline__ void ldsm_x4_trans_a(const void* p,
                                                uint32_t (&a)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(bf16_smem_addr(p)));
}

// c += a (16 x 16, row) b (16 x 8, col): bf16 in, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The cursor over one output's k-steps in the contract's order: tap (ki,
// kj), then channels ci0 .. ci0 + 15.  next() returns whether the tap
// changed.
struct KStep {
  int ki, kj, ci0;
  __device__ __forceinline__ bool next(int cin, int kw) {
    ci0 += kBf16MmaK;
    if (ci0 < cin) return false;
    ci0 = 0;
    if (++kj == kw) {
      kj = 0;
      ++ki;
    }
    return true;
  }
};

// `steps` (<= kMaxSteps) consecutive k-steps of a warp's fragments:
// acc[i][j] of m16 fragment i < m_frags and n8 fragment j < 4.  load(q, af,
// bf) fetches the A and B fragments of the q-th k-step (in order, q = 0,
// 1, ...); the fragments of k-step q + 1 are fetched before k-step q's
// products.  Each k-step is one mma per fragment, so every element's
// accumulator takes the k-steps in the order the caller walks them, one
// instruction each, and nothing else.
template <int kMaxSteps, int kMF, typename Load>
__device__ __forceinline__ void bf16_mma_steps(float (&acc)[kMF][4][4],
                                               int m_frags, int steps,
                                               Load&& load) {
  uint32_t af[2][kMF][4], bf[2][4][2];
  if (steps <= 0) return;
  load(0, af[0], bf[0]);
#pragma unroll
  for (int q = 0; q < kMaxSteps; ++q) {
    if (q >= steps) break;
    if (q + 1 < steps) load(q + 1, af[(q + 1) & 1], bf[(q + 1) & 1]);
#pragma unroll
    for (int i = 0; i < kMF; ++i)
      if (i < m_frags)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[q & 1][i],
                                             bf[q & 1][j]);
  }
}
