// The backward of flash attention for NVIDIA Hopper (sm_90a), f32, hand-
// written CUDA: FlashAttention-2's backward, redesigned for the H100's
// TF32 tensor cores, in three kernels.
//
// Replaces no TPU kernel: the JAX package has no backward kernel for
// _kernel of src/repro/kernels/flash_attention.py:31; it trains through
// ops.attention(impl="chunked") (src/repro/kernels/ops.py:867), which XLA
// differentiates.  The port's training path runs the forward kernel of
// csrc/flash_attention.cu, so its gradient needs these kernels.
//
// Math.  Each score is recomputed as the forward formed it:
//   x = (q . k) * scale;  y = cap * tanh(x / cap) when soft_cap > 0,
// for a valid (query, key) pair (causal, window, keys before Lk; queries
// right-aligned, query i at position i + Lk - Lq), and with dP = dO V^T:
//   dV = P^T dO,  dS = P (dP - delta) (1 - tanh^2 under the cap),
//   dK = scale dS^T Q,  dQ = scale dS K,  delta = rowsum(P o dP).
//
// Row statistics.  The dQ kernel's first pass takes each row's statistics
// from the backward's own scores, with the forward's lse = m + log(max(l,
// 1e-30)) as the reference point that keeps the exponents in range:
//   e = exp(y - lse),  l' = sum e,  lse' = lse + log l',
//   delta = sum e dP / l'.
// Then p = exp(y - lse') sums to 1 over the row and dS is that of an exact
// softmax of the recomputed scores.  The forward's 3xTF32 scores and a
// backward's own part by ~1e-3 at the peaked logits of a full-width LM
// (|y| ~ 2000 under the JAX initialiser); p from the forward's lse and
// delta = rowsum(dO o O) left a saturated row a spurious dS of that size
// (one layer's attention gradient up to 18x the f32 ref oracle's error
// from float64).  The dQ kernel writes lse' and delta for the dK / dV
// kernel, which runs after it.  The forward's O is not read.
//
// What bounds it on the H100.  The backward needs 10 D FLOPs a valid
// pair at the least (S, dP, dV, dK, dQ); at the LM training shape (t)
// (B 2, L 1024, Hq 16, Hkv 2, D 128, causal) that is 21.5 GFLOP against
// 42 MB of Q, K, V, dO, the gradients and the statistics: operations bound
// it.  At f32 accuracy on the tensor cores (3xTF32: three TF32 products a
// product, 495 TFLOP/s) the least is 0.130 ms; at 67 TFLOP/s of f32 FFMA,
// 0.321 ms.  This design does 18 D (S and dP are formed three times: twice
// in the dQ kernel, whose first pass is the statistics, once in dK / dV).
// The first design (FFMA chains, 128 dK / dV blocks at (t), plain loads
// between barriers) read 4.504 ms there.
//
// The design.
// (1) All five products run on mma.sync.m16n8k8 in 3xTF32 (tf32_mma.cuh):
// each operand split into big + small TF32 halves, three products a
// product.  The tensor cores truncate as they accumulate, so every product
// that runs over D (S, dP) takes each pair of k-steps into a fresh
// accumulator added to the sum in f32, and every product over the streamed
// rows (dQ, dK, dV) takes each tile's 16 rows (two k-steps) into a fresh
// accumulator, its small cross terms into one of their own.
// (2) Both kernels share one shape: a block of 4 warps holds 64 rows of two
// operands resident in shared memory, a warp 16 of them (the M of the
// mma), and streams tiles of 16 rows of two others (the N of S and dP, the
// k of the output products) through a two-stage cp.async ring, one barrier
// a tile.  dQ: Q and dO resident (rows position-major across the GQA
// group, as the forward's: row t is position t / G of head kvh G + t % G),
// K and V streamed.  dK / dV: K and V resident (keys as M), Q and dO of
// one query head streamed with each row's lse' and delta, so S^T = K Q^T
// and dP^T = V dO^T leave P^T and dS^T in accumulator registers, which
// feed dV += P^T dO and dK += dS^T Q as A operands (a lane holds rows 2t,
// 2t + 1 of a key; the A operand wants k = t, t + 4: the k index is
// permuted, k = t reading row 2t and k = t + 4 row 2t + 1, and the B
// fragments are read with the same permutation), as the forward feeds P
// into P V.  dQ += dS K likewise.  Each S-like product orders its three
// TF32 products so that a dK / dV score (K as A) and a dQ score (Q as A)
// add the same partial products in the same order.
// (3) The dK / dV grid is FlashAttention-2's GQA scheme: one block per
// (64-key tile, query head, batch), 512 blocks at (t) (PR 25: 128, one per
// KV head, on 132 SMs).  Each writes its head's partial dK and dV into
// scratch (2, G, B, Lk, Hkv, D); flash_attention_bwd_sum_kernel adds the G
// partials in head order (G = 1 writes the gradients directly and launches
// no sum).  Both kernels number their blocks tile-major, the tiles that
// see the most rows or keys under a causal mask first.  No float atomics:
// two launches give the same bits.
// (4) Shared memory, rows at a stride of Dp + 4 floats (conflict-free
// fragment reads): Dp 64 and 128 take 52 and 102 KB a block, two blocks an
// SM; Dp 256 takes 200 KB, one block, and there dK / dV runs two passes
// over the rows (dV, then dK), so each keeps one 16 x 256 accumulator (128
// registers a lane): 10 D FLOPs a pair in that kernel instead of 8.
// The wrapper's plan (kernels/flash_attention.py, bwd_plan) gives the
// grids and scratch; each launcher refuses a block count its constants do
// not give.
//
// bf16 (flash_attention_bwd_{dq,dkdv,sum}_bf16).  JAX trains through
// chunked_attention, which widens q, k and v to f32 and casts o once
// (src/repro/kernels/ops.py:845-846, :863, :920), so its bf16 gradient is
// f32 math on the widened values, rounded once per output.  The same three
// kernels run on bf16 Q, K, V and dO (the template's T): the resident rows
// and the ring hold bf16 at a stride of Dp + 8 elements (an odd count of
// 16-byte quads: no ldmatrix phase has a bank conflict), a 16-byte copy
// carries 8 elements, and the products run on the bf16 tensor cores,
// mma.sync m16n8k16 with f32 accumulators (bf16_mma.cuh), not on 3xTF32:
//   S = Q K^T and dP = dO V^T (and S^T = K Q^T, dP^T = V dO^T in dK / dV):
//     both operands bf16, so every product is exact in f32.  A: 16
//     resident rows x 16 d by ldmatrix.x4; B: the streamed tile's 16 rows
//     by non-transposed ldmatrix.x4 (d contiguous is the mma's "col" B):
//     one ldmatrix gives the b0 / b1 of both n8 tiles.  Two k-steps (32 d)
//     go into a fresh accumulator added to the score in f32, in the same
//     order in both kernels, so a dK / dV score and a dQ score take the
//     same products in the same order.
//   dV = P^T dO, dK = dS^T Q, dQ = dS K: the first operand is f32 (P, dS).
//     The C fragments of the two n8 score tiles of a streamed tile are the
//     A fragment of one k16 step as they stand (a lane holds k 2t, 2t + 1
//     and 2t + 8, 2t + 9 of rows g and g + 8), so no permutation is needed.
//     Each value is split, hi = bf16_rn(x) and lo = bf16_rn(x - hi) (x - hi
//     is exact in f32), and both meet the exact bf16 second operand (B by
//     ldmatrix.x4.trans from its [row][d] tile): hi + lo keeps x to within
//     2^-16 of itself, where one bf16 rounding would leave 2^-8 (the
//     forward's P V split).  Per tile a fresh accumulator each for
//     the hi and lo products, added to the output as hi + lo.
// Everything else is the f32 route's: the row statistics from the
// backward's own scores, the masks, the per-head f32 partials (dK / dV for
// G > 1) summed in head order by the sum kernel, no float atomics.  dQ, and
// dK and dV (by the sum kernel, or by dK / dV itself for G = 1), are
// rounded once to bf16 at their stores.  At (t) the tensor-core work is
// (S, dP) x 3 + (dV, dK, dQ) x 2 x 2 = 18 D FLOPs a valid pair at 989
// TFLOP/s, against 10 D at the least: the bound is 10 D FLOPs a pair over
// 989 TFLOP/s.  Shared memory is half the f32 route's: Dp 64, 128 and 256
// take 27, 51 and 102 KB a block, two blocks an SM at every Dp; Dp 256
// keeps dK / dV's two passes (the f32 accumulators are the same size).
//
// Left for later: wgmma, operands split once into shared memory, the wide
// route (D > 256).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "cp_async.cuh"
#include "elem.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = 4;                 // warps a block, both kernels
constexpr int kThreads = kWarps * 32;
constexpr int kBlockRows = 16 * kWarps;   // resident rows: dQ rows, dK/dV keys
constexpr int kTile = 16;                 // streamed rows a ring stage
constexpr int kStages = 2;
constexpr int kMaxDp = 256;               // the forward's narrow route
constexpr int kSumThreads = 256;
constexpr int kMaxSmemBytes = 232448;     // H100: 227 KB opt-in per block

constexpr int kJ = kTile / 8;             // m16n8 tiles of a score row

// Row stride of the shared tiles in elements: 16 bytes of padding, so rows
// stay 16-byte aligned for cp.async and the fragment reads conflict-free
// (f32: Dp + 4; bf16: Dp + 8, an odd count of 16-byte quads)
template <typename T>
__host__ __device__ constexpr int row_stride(int dp) {
  return dp + 16 / (int)sizeof(T);
}

template <typename T>
struct BwdArgs {
  const T *q, *k, *v, *dout;
  const float *lse;       // the forward's (B, Hq, Lq), read by dq
  float *stats;           // (2, B, Hq, Lq): lse' and delta, dq -> dkdv
  void *out_a, *out_b;    // dq: dQ (T); dkdv: dK and dV, f32 partials
                          // (G, B, Lk, Hkv, D) or, for G = 1, the T outputs
  int b, lq, lk, hq, hkv, d, group;
  int64_t q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh;
  int64_t do_sb, do_sl, do_sh;
  int causal, window;     // window <= 0: none
  float soft_cap;         // <= 0: none
  float sm_scale;
  int tiles;              // dq: row tiles; dkdv: key tiles
  int vec;                // q, k, v, dO rows copied 16 bytes at a time
};

// Bytes of one ring stage: two streamed operands of kTile rows, then (the
// dK / dV kernel's) each row's lse' and delta
template <typename T, int kDp>
__host__ __device__ constexpr size_t stage_bytes() {
  return (size_t)2 * kTile * row_stride<T>(kDp) * sizeof(T) +
         (size_t)2 * kTile * sizeof(float);
}

template <typename T, int kDp>
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  // two resident operands of kBlockRows rows and kStages ring stages
  return (size_t)2 * kBlockRows * row_stride<T>(kDp) * sizeof(T) +
         kStages * stage_bytes<T, kDp>();
}

// Rows [0, n) into shared memory at the row stride: row r from src(r)
// (nullptr: zeros), its first d columns, zeros past them.  bf16 without
// 16-byte rows: plain loads and stores (cp.async has no 2-byte copy), seen
// by the other threads after the ring's next barrier.
template <typename T, int kDp, typename Src>
__device__ __forceinline__ void copy_rows(T *dst, int n, Src src, int d,
                                          int vec, const T *any) {
  constexpr int kS = row_stride<T>(kDp);
  constexpr int kE = 16 / (int)sizeof(T);   // elements a 16-byte copy
  if (vec) {
    for (int e = threadIdx.x; e < n * (kDp / kE); e += kThreads) {
      const int r = e / (kDp / kE), c = kE * (e % (kDp / kE));
      const T *p = src(r);
      const bool ok = p != nullptr && c < d;
      cp_async16(reinterpret_cast<float *>(dst + r * kS + c),
                 reinterpret_cast<const float *>(ok ? p + c : any), ok);
    }
  } else {
    for (int e = threadIdx.x; e < n * kDp; e += kThreads) {
      const int r = e / kDp, c = e % kDp;
      const T *p = src(r);
      const bool ok = p != nullptr && c < d;
      if constexpr (sizeof(T) == 4) {
        cp_async4(dst + r * kS + c, ok ? p + c : any, ok);
      } else {
        dst[r * kS + c] =
            ok ? __ushort_as_bfloat16(
                     __ldg(reinterpret_cast<const unsigned short *>(p + c)))
               : __ushort_as_bfloat16(0);
      }
    }
  }
}

// Tiles [begin, end) through the two-stage ring: load(tile, stage) issues
// a tile's copies, body(tile, stage) consumes it; tile j + 1 is copied
// while tile j computes, one barrier a tile.  Copies issued before the
// call join the first tile's group.
template <typename Load, typename Body>
__device__ __forceinline__ void stream_tiles(int begin, int end, Load load,
                                             Body body) {
  if (begin < end) load(begin, 0);
  cp_async_commit();
  for (int it = begin; it < end; ++it) {
    const int stage = (it - begin) & 1;
    cp_async_wait<0>();   // this thread's copies of tile it
    __syncthreads();       // everyone's; the other stage is consumed
    if (it + 1 < end) load(it + 1, stage ^ 1);
    cp_async_commit();
    body(it, stage);
  }
}

// c[j] = the m16n8 tiles of X_w Y^T: X_w the warp's 16 resident rows (xw),
// Y a streamed tile's kTile rows (ys), over kDp columns in 3xTF32, each
// pair of k-steps into a fresh accumulator added to c in f32.  kYFirst:
// Y's small half meets X's big half first (X = K or V in dK / dV, so that
// its scores add the same partial products in the same order as dQ's,
// where X = Q or dO).
template <int kDp, bool kYFirst>
__device__ __forceinline__ void tile_scores(const float *xw, const float *ys,
                                            float (&c)[kJ][4]) {
  constexpr int kS = row_stride<float>(kDp);
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll 2
  for (int d0 = 0; d0 < kDp; d0 += 16) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float *xr = xw + gq * kS + d0 + 8 * h + tq;
      split_tf32(xr[0], ab[h][0], as[h][0]);
      split_tf32(xr[8 * kS], ab[h][1], as[h][1]);
      split_tf32(xr[4], ab[h][2], as[h][2]);
      split_tf32(xr[8 * kS + 4], ab[h][3], as[h][3]);
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float *yr = ys + (8 * j + gq) * kS + d0 + 8 * h + tq;
        uint32_t bb[2], bs[2];
        split_tf32(yr[0], bb[0], bs[0]);
        split_tf32(yr[4], bb[1], bs[1]);
        if (kYFirst) {
          mma_tf32(t, ab[h], bs);
          mma_tf32(t, as[h], bb);
          mma_tf32(t, ab[h], bb);
        } else {
          mma_3xtf32(t, t, ab[h], as[h], bb, bs);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] += t[e];
    }
  }
}

// The same on bf16 rows, on the bf16 tensor cores: X_w by ldmatrix.x4
// (lane: row (l & 7) + 8 ((l >> 3) & 1), d 8 (l >> 4) on), Y's 16 rows by
// non-transposed ldmatrix.x4 (lane: row (l & 7) + 8 (l >> 4), d 8 ((l >> 3)
// & 1) on: b0 / b1 of both n8 tiles).  Exact products; two k-steps (32 d)
// into a fresh accumulator added to c in f32.  X and Y take the same
// products in the same order whichever is A, so kYFirst has nothing to do.
template <int kDp, bool kYFirst>
__device__ __forceinline__ void tile_scores(const __nv_bfloat16 *xw,
                                            const __nv_bfloat16 *ys,
                                            float (&c)[kJ][4]) {
  constexpr int kS = row_stride<__nv_bfloat16>(kDp);
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16 *xa =
      xw + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kS + 8 * (lane >> 4);
  const __nv_bfloat16 *ya =
      ys + ((lane & 7) + 8 * (lane >> 4)) * kS + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll 2
  for (int d0 = 0; d0 < kDp; d0 += 32) {
    float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t af[4], yb[4];
      ldsm_x4(xa + d0 + 16 * h, af);
      ldsm_x4(ya + d0 + 16 * h, yb);
      const uint32_t b0[2] = {yb[0], yb[1]}, b1[2] = {yb[2], yb[3]};
      mma_bf16(t0, af, b0);
      mma_bf16(t1, af, b1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      c[0][e] += t0[e];
      c[1][e] += t1[e];
    }
  }
}

// acc[c] (the m16n8 tiles of the warp's 16 rows x kDp columns) += A Y: A
// (16 x kTile) in accumulator layout (p[j][0..1]: row gq, k 8 j + 2 tq,
// + 1; [2..3]: row gq + 8), Y the streamed tile (ys, kTile rows of kDp).
// The k index is permuted: k = tq of a k-step reads Y's row 2 tq, k =
// tq + 4 row 2 tq + 1.  One fresh accumulator a tile, its cross terms in
// another, added to acc in f32.
template <int kDp>
__device__ __forceinline__ void accumulate(float (&acc)[kDp / 8][4],
                                           const float (&p)[kJ][4],
                                           const float *ys) {
  constexpr int kS = row_stride<float>(kDp);
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  uint32_t pb[kJ][4], ps[kJ][4];
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    split_tf32(p[j][0], pb[j][0], ps[j][0]);
    split_tf32(p[j][2], pb[j][1], ps[j][1]);
    split_tf32(p[j][1], pb[j][2], ps[j][2]);
    split_tf32(p[j][3], pb[j][3], ps[j][3]);
  }
  const float *yr = ys + 2 * tq * kS + gq;
#pragma unroll
  for (int c = 0; c < kDp / 8; ++c) {
    float t[4] = {0.f, 0.f, 0.f, 0.f}, tc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      uint32_t bb[2], bs[2];
      split_tf32(yr[8 * j * kS + 8 * c], bb[0], bs[0]);
      split_tf32(yr[(8 * j + 1) * kS + 8 * c], bb[1], bs[1]);
      mma_3xtf32(t, tc, pb[j], ps[j], bb, bs);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] += t[e] + tc[e];
  }
}

// Two f32 values (the lower k first) as bf16 pairs: hi = bf16_rn(x),
// lo = bf16_rn(x - hi); x - hi is exact in f32
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t &hi,
                                           uint32_t &lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
  const __nv_bfloat16 l0 = __float2bfloat16_rn(x0 - __bfloat162float(h0));
  const __nv_bfloat16 l1 = __float2bfloat16_rn(x1 - __bfloat162float(h1));
  hi = (uint32_t)__bfloat16_as_ushort(h0) |
       ((uint32_t)__bfloat16_as_ushort(h1) << 16);
  lo = (uint32_t)__bfloat16_as_ushort(l0) |
       ((uint32_t)__bfloat16_as_ushort(l1) << 16);
}

// The same on a bf16 tile: the kTile = 16 streamed rows are one k16 step.
// p's two n8 tiles are its A fragment as they stand (a0 / a1: p[0] rows
// gq / gq + 8, k 2 tq; a2 / a3: p[1], k 2 tq + 8), split into hi and lo;
// Y's B fragments of two 8-column tiles by ldmatrix.x4.trans (lane: row
// (l & 7) + 8 ((l >> 3) & 1), d 8 (l >> 4) on).  A fresh accumulator each
// for the hi and lo products, added to acc as hi + lo.
template <int kDp>
__device__ __forceinline__ void accumulate(float (&acc)[kDp / 8][4],
                                           const float (&p)[kJ][4],
                                           const __nv_bfloat16 *ys) {
  constexpr int kS = row_stride<__nv_bfloat16>(kDp);
  const int lane = threadIdx.x % 32;
  uint32_t ph[4], pl[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float *src = p[r >> 1] + 2 * (r & 1);
    split_bf16(src[0], src[1], ph[r], pl[r]);
  }
  const __nv_bfloat16 *ya =
      ys + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kS + 8 * (lane >> 4);
#pragma unroll
  for (int c2 = 0; c2 < kDp / 16; ++c2) {
    uint32_t yb[2][2];
    ldsm_x4_trans(ya + 16 * c2, yb[0], yb[1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float th[4] = {0.f, 0.f, 0.f, 0.f}, tl[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(tl, pl, yb[i]);
      mma_bf16(th, ph, yb[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[2 * c2 + i][e] += th[e] + tl[e];
    }
  }
}

template <int kDp>
__device__ __forceinline__ void zero(float (&acc)[kDp / 8][4]) {
#pragma unroll
  for (int c = 0; c < kDp / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
}

// The scaled, capped score y of a raw product s, and (in chain) the cap's
// derivative 1 - tanh^2 (1 without a cap)
template <typename T>
__device__ __forceinline__ float capped(const BwdArgs<T> &a, float s,
                                        float &chain) {
  float y = s * a.sm_scale;
  chain = 1.f;
  if (a.soft_cap > 0.f) {
    const float th = tanhf(y / a.soft_cap);
    y = a.soft_cap * th;
    chain = 1.f - th * th;
  }
  return y;
}

// Whether a query at position q_pos (absolute) sees key kp
template <typename T>
__device__ __forceinline__ bool sees(const BwdArgs<T> &a, int q_pos, int kp) {
  bool ok = kp < a.lk;
  if (a.causal) ok = ok && q_pos >= kp;
  if (a.window > 0) ok = ok && q_pos - kp < a.window;
  return ok;
}

template <typename T, int kDp>
__global__ void __launch_bounds__(kThreads,
                                  kDp <= 128 || sizeof(T) == 2 ? 2 : 1)
    flash_attention_bwd_dq_kernel(const BwdArgs<T> a) {
  constexpr int kS = row_stride<T>(kDp);
  extern __shared__ float4 smem4[];
  T *qs = reinterpret_cast<T *>(smem4);
  T *dos = qs + kBlockRows * kS;
  char *ring = reinterpret_cast<char *>(dos + kBlockRows * kS);
  // [stage][K, V][key][d]
  auto stage_k = [&](int stage) {
    return reinterpret_cast<T *>(ring + stage * stage_bytes<T, kDp>());
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  // tile-major: the last row tiles, the longest under a causal mask, first
  const int per_tile = a.hkv * a.b;
  const int tile = a.tiles - 1 - (int)blockIdx.x / per_tile;
  const int kvh = (int)blockIdx.x % per_tile % a.hkv;
  const int b = (int)blockIdx.x % per_tile / a.hkv;
  const int g = a.group, n_rows = a.lq * g, off = a.lk - a.lq;
  const int t0 = tile * kBlockRows;

  // the forward's key range of the block's rows
  const int last = min(t0 + kBlockRows, n_rows) - 1;
  const int pos_lo = t0 / g + off, pos_hi = last / g + off;
  int k_end = a.lk, k_begin = 0;
  if (a.causal) k_end = min(k_end, pos_hi + 1);
  if (a.window > 0) k_begin = max(0, pos_lo - a.window + 1);
  const int kt_begin = k_begin / kTile;
  const int kt_end = k_end > k_begin ? (k_end + kTile - 1) / kTile : kt_begin;

  // resident Q and dO: row r is (position (t0 + r) / G, head kvh G + ..)
  auto row_of = [&](const T *base, int64_t sb, int64_t sl, int64_t sh) {
    return [=](int r) -> const T * {
      const int t = t0 + r;
      if (t >= n_rows) return nullptr;
      return base + (int64_t)b * sb + (int64_t)(t / g) * sl +
             (int64_t)(kvh * g + t % g) * sh;
    };
  };
  copy_rows<T, kDp>(qs, kBlockRows, row_of(a.q, a.q_sb, a.q_sl, a.q_sh), a.d,
                    a.vec, a.q);
  copy_rows<T, kDp>(dos, kBlockRows,
                    row_of(a.dout, a.do_sb, a.do_sl, a.do_sh), a.d, a.vec,
                    a.q);
  const T *kbase = a.k + (int64_t)b * a.k_sb + (int64_t)kvh * a.k_sh;
  const T *vbase = a.v + (int64_t)b * a.v_sb + (int64_t)kvh * a.v_sh;
  auto load = [&](int kt, int stage) {
    T *kd = stage_k(stage), *vd = kd + kTile * kS;
    const int k0 = kt * kTile;
    copy_rows<T, kDp>(kd, kTile, [=](int r) -> const T * {
      return k0 + r < a.lk ? kbase + (int64_t)(k0 + r) * a.k_sl : nullptr;
    }, a.d, a.vec, a.q);
    copy_rows<T, kDp>(vd, kTile, [=](int r) -> const T * {
      return k0 + r < a.lk ? vbase + (int64_t)(k0 + r) * a.v_sl : nullptr;
    }, a.d, a.vec, a.q);
  };

  // this lane's rows: warp * 16 + gq (i = 0) and + 8 (i = 1)
  int q_pos[2];
  bool row_ok[2];
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + warp * 16 + gq + 8 * i;
    row_ok[i] = t < n_rows;
    q_pos[i] = t / g + off;
    lse[i] = row_ok[i] ? __ldg(a.lse + ((int64_t)b * a.hq + kvh * g + t % g) *
                                           a.lq + t / g)
                       : 0.f;
  }
  const T *qw = qs + warp * 16 * kS, *dow = dos + warp * 16 * kS;

  // pass 1: the rows' statistics under this kernel's scores (see "Row
  // statistics" above): e = exp(y - lse), l' = sum e, t' = sum e dP
  float lsum[2] = {0.f, 0.f}, tsum[2] = {0.f, 0.f};
  stream_tiles(kt_begin, kt_end, load, [&](int kt, int stage) {
    const T *ks = stage_k(stage), *vs = ks + kTile * kS;
    float s[kJ][4], dp[kJ][4];
    tile_scores<kDp, false>(qw, ks, s);
    tile_scores<kDp, false>(dow, vs, dp);
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2, kp = kt * kTile + 8 * j + 2 * tq + e % 2;
        float chain;
        const float y = capped(a, s[j][e], chain);
        if (row_ok[i] && sees(a, q_pos[i], kp)) {
          const float ev = expf(y - lse[i]);
          lsum[i] += ev;
          tsum[i] = fmaf(ev, dp[j][e], tsum[i]);
        }
      }
  });
  // each row's 4 lanes' sums, added in the same order on all four: lse'
  // and delta
  const int64_t n_stats = (int64_t)a.b * a.hq * a.lq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l2 = lsum[i], t2 = tsum[i];
    l2 += __shfl_xor_sync(0xffffffffu, l2, 1);
    t2 += __shfl_xor_sync(0xffffffffu, t2, 1);
    l2 += __shfl_xor_sync(0xffffffffu, l2, 2);
    t2 += __shfl_xor_sync(0xffffffffu, t2, 2);
    float lse2 = 0.f, dl = 0.f;   // rows past the last: never read
    if (row_ok[i] && l2 > 0.f) {
      lse2 = lse[i] + logf(l2);
      dl = t2 / l2;
      if (tq == 0) {
        const int t = t0 + warp * 16 + gq + 8 * i;
        const int64_t idx =
            ((int64_t)b * a.hq + kvh * g + t % g) * a.lq + t / g;
        a.stats[idx] = lse2;
        a.stats[n_stats + idx] = dl;
      }
    }
    lse[i] = lse2;
    delta[i] = dl;
  }
  __syncthreads();   // pass 1's last tile is consumed before pass 2 loads

  // pass 2: dQ += dS K
  float dq[kDp / 8][4];
  zero<kDp>(dq);
  stream_tiles(kt_begin, kt_end, load, [&](int kt, int stage) {
    const T *ks = stage_k(stage), *vs = ks + kTile * kS;
    float s[kJ][4], dp[kJ][4];
    tile_scores<kDp, false>(qw, ks, s);
    tile_scores<kDp, false>(dow, vs, dp);
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2, kp = kt * kTile + 8 * j + 2 * tq + e % 2;
        float chain;
        const float y = capped(a, s[j][e], chain);
        const bool ok = row_ok[i] && sees(a, q_pos[i], kp);
        s[j][e] = ok ? expf(y - lse[i]) * (dp[j][e] - delta[i]) * chain : 0.f;
      }
    accumulate<kDp>(dq, s, ks);
  });

  // dQ (scaled), contiguous (B, Lq, Hq, D) of T, rounded once: dq[c][2 i +
  // e] is row gq + 8 i, column 8 c + 2 tq + e
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + warp * 16 + gq + 8 * i;
    if (t >= n_rows) continue;
    T *dst = static_cast<T *>(a.out_a) +
             (((int64_t)b * a.lq + t / g) * a.hq + kvh * g + t % g) * a.d;
#pragma unroll
    for (int c = 0; c < kDp / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * c + 2 * tq + e;
        if (col < a.d) store_elem(dst + col, dq[c][2 * i + e] * a.sm_scale);
      }
  }
}

// One pass of a dK / dV block over its query rows: dV += P^T dO (kDV) and
// dK += dS^T Q (kDK) for the warp's 16 keys, written (dK scaled) into the
// head's partial (O = float) or, for G = 1, the gradients (O = T).  kw,
// vw: the warp's K and V rows.
template <typename T, typename O, int kDp, bool kDV, bool kDK>
__device__ __forceinline__ void dkdv_pass(const BwdArgs<T> &a, int b, int h,
                                          int k0, int rt_begin, int rt_end,
                                          const T *kw, const T *vw,
                                          char *ring) {
  constexpr int kS = row_stride<T>(kDp);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int kvh = h / a.group, off = a.lk - a.lq;
  const int64_t n_stats = (int64_t)a.b * a.hq * a.lq;
  const T *qbase = a.q + (int64_t)b * a.q_sb + (int64_t)h * a.q_sh;
  const T *obase = a.dout + (int64_t)b * a.do_sb + (int64_t)h * a.do_sh;
  const float *sbase = a.stats + ((int64_t)b * a.hq + h) * a.lq;
  // [stage][Q, dO, lse', delta]
  auto stage_q = [&](int stage) {
    return reinterpret_cast<T *>(ring + stage * stage_bytes<T, kDp>());
  };
  auto load = [&](int rt, int stage) {
    T *qd = stage_q(stage), *od = qd + kTile * kS;
    float *ld = reinterpret_cast<float *>(od + kTile * kS);
    const int r0 = rt * kTile;
    copy_rows<T, kDp>(qd, kTile, [=](int r) -> const T * {
      return r0 + r < a.lq ? qbase + (int64_t)(r0 + r) * a.q_sl : nullptr;
    }, a.d, a.vec, a.q);
    copy_rows<T, kDp>(od, kTile, [=](int r) -> const T * {
      return r0 + r < a.lq ? obase + (int64_t)(r0 + r) * a.do_sl : nullptr;
    }, a.d, a.vec, a.q);
    for (int e = threadIdx.x; e < 2 * kTile; e += kThreads) {
      const int r = e % kTile;
      const bool ok = r0 + r < a.lq;
      cp_async4(ld + e, ok ? sbase + (e / kTile) * n_stats + r0 + r : a.lse,
                ok);
    }
  };

  // this lane's keys: warp * 16 + gq (i = 0) and + 8 (i = 1)
  float dk[kDp / 8][4], dv[kDp / 8][4];   // the pass's own: the other is dead
  zero<kDp>(dk);
  zero<kDp>(dv);

  stream_tiles(rt_begin, rt_end, load, [&](int rt, int stage) {
    const T *qt = stage_q(stage), *ot = qt + kTile * kS;
    const float *ls = reinterpret_cast<const float *>(ot + kTile * kS);
    const float *dls = ls + kTile;
    // S^T and dP^T: s[j][e] is key gq + 8 (e / 2), row 8 j + 2 tq + e % 2
    float s[kJ][4], dp[kJ][4];
    tile_scores<kDp, true>(kw, qt, s);
    if constexpr (kDK) tile_scores<kDp, true>(vw, ot, dp);
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * j + 2 * tq + e % 2;
        const int kp = k0 + warp * 16 + gq + 8 * (e / 2);
        float chain;
        const float y = capped(a, s[j][e], chain);
        const bool ok = rt * kTile + r < a.lq &&
                        sees(a, rt * kTile + r + off, kp);
        const float p = ok ? expf(y - ls[r]) : 0.f;
        s[j][e] = p;
        if constexpr (kDK)
          dp[j][e] = ok ? p * (dp[j][e] - dls[r]) * chain : 0.f;
      }
    if constexpr (kDV) accumulate<kDp>(dv, s, ot);
    if constexpr (kDK) accumulate<kDp>(dk, dp, qt);
  });

  // the head's partial, (B, Lk, Hkv, D) at slot h % G: dk[c][2 i + e] is
  // key gq + 8 i, column 8 c + 2 tq + e
  O *out_k = static_cast<O *>(a.out_a), *out_v = static_cast<O *>(a.out_b);
  const int64_t part = ((int64_t)(h % a.group) * a.b + b) * a.lk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = k0 + warp * 16 + gq + 8 * i;
    if (kp >= a.lk) continue;
    const int64_t base = ((part + kp) * a.hkv + kvh) * a.d;
#pragma unroll
    for (int c = 0; c < kDp / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * c + 2 * tq + e;
        if (col >= a.d) continue;
        if constexpr (kDK)
          store_elem(out_k + base + col, dk[c][2 * i + e] * a.sm_scale);
        if constexpr (kDV) store_elem(out_v + base + col, dv[c][2 * i + e]);
      }
  }
}

template <typename T, typename O, int kDp>
__global__ void __launch_bounds__(kThreads,
                                  kDp <= 128 || sizeof(T) == 2 ? 2 : 1)
    flash_attention_bwd_dkdv_kernel(const BwdArgs<T> a) {
  constexpr int kS = row_stride<T>(kDp);
  extern __shared__ float4 smem4[];
  T *ks = reinterpret_cast<T *>(smem4);
  T *vs = ks + kBlockRows * kS;
  char *ring = reinterpret_cast<char *>(vs + kBlockRows * kS);

  const int warp = threadIdx.x / 32;
  // tile-major: key tile 0, the longest under a causal mask, first
  const int per_tile = a.hq * a.b;
  const int kt = (int)blockIdx.x / per_tile;
  const int h = (int)blockIdx.x % per_tile % a.hq;
  const int b = (int)blockIdx.x % per_tile / a.hq;
  const int kvh = h / a.group, off = a.lk - a.lq;
  const int k0 = kt * kBlockRows, k1 = min(k0 + kBlockRows, a.lk);

  // the query positions that see a key of [k0, k1)
  int qi_lo = 0, qi_hi = a.lq - 1;
  if (a.causal) qi_lo = max(qi_lo, k0 - off);
  if (a.window > 0) qi_hi = min(qi_hi, k1 - 1 + a.window - 1 - off);
  const int rt_begin = qi_lo / kTile;
  const int rt_end = qi_hi >= qi_lo ? qi_hi / kTile + 1 : rt_begin;

  const T *kbase = a.k + (int64_t)b * a.k_sb + (int64_t)kvh * a.k_sh;
  const T *vbase = a.v + (int64_t)b * a.v_sb + (int64_t)kvh * a.v_sh;
  copy_rows<T, kDp>(ks, kBlockRows, [=](int r) -> const T * {
    return k0 + r < a.lk ? kbase + (int64_t)(k0 + r) * a.k_sl : nullptr;
  }, a.d, a.vec, a.q);
  copy_rows<T, kDp>(vs, kBlockRows, [=](int r) -> const T * {
    return k0 + r < a.lk ? vbase + (int64_t)(k0 + r) * a.v_sl : nullptr;
  }, a.d, a.vec, a.q);
  const T *kw = ks + warp * 16 * kS, *vw = vs + warp * 16 * kS;
  if constexpr (kDp <= 128) {
    dkdv_pass<T, O, kDp, true, true>(a, b, h, k0, rt_begin, rt_end, kw, vw,
                                     ring);
  } else {
    // 16 x 256 accumulators: dV and dK in two passes over the rows
    dkdv_pass<T, O, kDp, true, false>(a, b, h, k0, rt_begin, rt_end, kw, vw,
                                      ring);
    __syncthreads();   // the first pass's last tile is consumed
    dkdv_pass<T, O, kDp, false, true>(a, b, h, k0, rt_begin, rt_end, kw, vw,
                                      ring);
  }
}

// Four consecutive f32 values stored as O (16 bytes of f32; 8 of bf16,
// rounded once); the pointer is aligned to that size
__device__ __forceinline__ void store4(float *p, float4 v) {
  *reinterpret_cast<float4 *>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16 *p, float4 v) {
  const auto pack = [](float x0, float x1) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x0)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x1)) << 16);
  };
  *reinterpret_cast<uint2 *>(p) = make_uint2(pack(v.x, v.y), pack(v.z, v.w));
}

// dK and dV: the G heads' f32 partials (2, G, n) summed in head order and
// stored as O, four elements a thread (16-byte partial reads where vec:
// n % 4 == 0, aligned)
template <typename O>
__global__ void __launch_bounds__(kSumThreads)
    flash_attention_bwd_sum_kernel(const float *part, O *dk, O *dv,
                                   int64_t n, int g, int vec) {
  const int64_t e0 = 4 * ((int64_t)blockIdx.x * kSumThreads + threadIdx.x);
  if (vec && e0 < n) {
    float4 sk = *reinterpret_cast<const float4 *>(part + e0);
    float4 sv = *reinterpret_cast<const float4 *>(part + g * n + e0);
    for (int i = 1; i < g; ++i) {
      const float4 xk = *reinterpret_cast<const float4 *>(part + i * n + e0);
      const float4 xv =
          *reinterpret_cast<const float4 *>(part + (g + i) * n + e0);
      sk.x += xk.x; sk.y += xk.y; sk.z += xk.z; sk.w += xk.w;
      sv.x += xv.x; sv.y += xv.y; sv.z += xv.z; sv.w += xv.w;
    }
    store4(dk + e0, sk);
    store4(dv + e0, sv);
    return;
  }
  for (int64_t e = e0; e < min(e0 + 4, n); ++e) {
    float sk = part[e], sv = part[g * n + e];
    for (int i = 1; i < g; ++i) {
      sk += part[i * n + e];
      sv += part[(g + i) * n + e];
    }
    store_elem(dk + e, sk);
    store_elem(dv + e, sv);
  }
}

template <typename T, int kDp>
int launch_dq(BwdArgs<T> a, int blocks, void *stream) {
  constexpr size_t smem = bwd_smem_bytes<T, kDp>();
  static_assert(smem <= (size_t)kMaxSmemBytes, "tile exceeds shared memory");
  const int64_t tiles =
      ((int64_t)a.lq * a.group + kBlockRows - 1) / kBlockRows;
  const int64_t grid = tiles * a.hkv * a.b;
  if (grid != blocks) return (int)cudaErrorInvalidValue;
  auto kernel = flash_attention_bwd_dq_kernel<T, kDp>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  a.tiles = (int)tiles;
  kernel<<<(unsigned)grid, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename O, int kDp>
int launch_dkdv(BwdArgs<T> a, int blocks, void *stream) {
  constexpr size_t smem = bwd_smem_bytes<T, kDp>();
  static_assert(smem <= (size_t)kMaxSmemBytes, "tile exceeds shared memory");
  const int64_t tiles = (a.lk + kBlockRows - 1) / kBlockRows;
  const int64_t grid = tiles * a.hq * a.b;
  if (grid != blocks) return (int)cudaErrorInvalidValue;
  auto kernel = flash_attention_bwd_dkdv_kernel<T, O, kDp>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  a.tiles = (int)tiles;
  kernel<<<(unsigned)grid, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The argument checks and the struct every entry point shares; returns
// cudaErrorInvalidValue for a geometry the kernels cannot take
template <typename T>
int make_args(BwdArgs<T> &a, const T *q, const T *k, const T *v,
              const T *dout, const float *lse, float *stats, void *out_a,
              void *out_b, int b, int lq, int lk, int hq, int hkv, int d,
              int64_t q_sb, int64_t q_sl, int64_t q_sh, int64_t k_sb,
              int64_t k_sl, int64_t k_sh, int64_t v_sb, int64_t v_sl,
              int64_t v_sh, int64_t do_sb, int64_t do_sl, int64_t do_sh,
              int causal, int window, float soft_cap, float sm_scale) {
  if (b < 1 || lq < 1 || lk < 1 || hkv < 1 || hq < hkv || hq % hkv != 0 ||
      d < 1 || d > kMaxDp || (causal && lq > lk) ||
      (int64_t)lq * (hq / hkv) > ((int64_t)1 << 30) ||
      (int64_t)b * hq * ((lk + kBlockRows - 1) / kBlockRows) > 2147483647 ||
      (int64_t)b * hkv * ((int64_t)lq * (hq / hkv) / kBlockRows + 1) >
          2147483647)
    return (int)cudaErrorInvalidValue;
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.stats = stats;
  a.out_a = out_a; a.out_b = out_b;
  a.b = b; a.lq = lq; a.lk = lk; a.hq = hq; a.hkv = hkv; a.d = d;
  a.group = hq / hkv;
  a.q_sb = q_sb; a.q_sl = q_sl; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_sl = k_sl; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_sl = v_sl; a.v_sh = v_sh;
  a.do_sb = do_sb; a.do_sl = do_sl; a.do_sh = do_sh;
  a.causal = causal; a.window = window; a.soft_cap = soft_cap;
  a.sm_scale = sm_scale;
  a.tiles = 0;
  const auto al16 = [](const void *p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  constexpr int kE = 16 / (int)sizeof(T);   // elements a 16-byte copy
  a.vec = d % kE == 0 && al16(q) && al16(k) && al16(v) && al16(dout) &&
          q_sb % kE == 0 && q_sl % kE == 0 && q_sh % kE == 0 &&
          k_sb % kE == 0 && k_sl % kE == 0 && k_sh % kE == 0 &&
          v_sb % kE == 0 && v_sl % kE == 0 && v_sh % kE == 0 &&
          do_sb % kE == 0 && do_sl % kE == 0 && do_sh % kE == 0;
  return 0;
}

template <typename T>
int run_dkdv(const BwdArgs<T> &a, int blocks, void *stream) {
  if (a.out_b == nullptr) return (int)cudaErrorInvalidValue;
  // G = 1 writes the gradients (T); G > 1 the f32 partials
  if (a.group == 1) {
    if (a.d <= 64) return launch_dkdv<T, T, 64>(a, blocks, stream);
    if (a.d <= 128) return launch_dkdv<T, T, 128>(a, blocks, stream);
    return launch_dkdv<T, T, 256>(a, blocks, stream);
  }
  if (a.d <= 64) return launch_dkdv<T, float, 64>(a, blocks, stream);
  if (a.d <= 128) return launch_dkdv<T, float, 128>(a, blocks, stream);
  return launch_dkdv<T, float, 256>(a, blocks, stream);
}

template <typename T>
int run_dq(const BwdArgs<T> &a, int blocks, void *stream) {
  if (a.d <= 64) return launch_dq<T, 64>(a, blocks, stream);
  if (a.d <= 128) return launch_dq<T, 128>(a, blocks, stream);
  return launch_dq<T, 256>(a, blocks, stream);
}

template <typename O>
int run_sum(const float *part, O *dk, O *dv, int64_t n, int g, int blocks,
            void *stream) {
  if (n < 1 || g < 2 ||
      (n + 4 * kSumThreads - 1) / (4 * kSumThreads) != blocks)
    return (int)cudaErrorInvalidValue;
  const auto al = [](const void *p, size_t bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  const int vec = n % 4 == 0 && al(part, 16) && al(dk, 4 * sizeof(O)) &&
                  al(dv, 4 * sizeof(O));
  flash_attention_bwd_sum_kernel<O><<<(unsigned)blocks, kSumThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      part, dk, dv, n, g, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes by repro_torch/kernels/build.py.  Each
// launches on `stream` without synchronising and returns cudaGetLastError()
// (or cudaErrorInvalidValue for a geometry the kernels cannot take: D >
// 256 has no backward here; or a block count `blocks`, the wrapper's plan,
// that the kernel's constants do not give).  q, k, v and dO are read
// through their strides (in elements; the head dim contiguous); lse (the
// forward's) is contiguous (B, Hq, Lq) f32 and stats (2, B, Hq, Lq) f32;
// the outputs are written contiguous.  Launch dq first (it writes the stats
// dkdv reads), then dkdv, then, for G > 1, sum.  The _bf16 entries take
// bf16 q, k, v and dO and write bf16 dQ (and dK, dV for G = 1; the
// partials stay f32).
extern "C" {

#define BWD_PARAMS(T)                                                       \
  const T *q, const T *k, const T *v, const T *dout, const float *lse,     \
      float *stats, void *out_a, void *out_b, int b, int lq, int lk,       \
      int hq, int hkv, int d, int64_t q_sb, int64_t q_sl, int64_t q_sh,    \
      int64_t k_sb, int64_t k_sl, int64_t k_sh, int64_t v_sb,              \
      int64_t v_sl, int64_t v_sh, int64_t do_sb, int64_t do_sl,            \
      int64_t do_sh, int causal, int window, float soft_cap,               \
      float sm_scale, int blocks, void *stream
#define BWD_ARGS                                                          \
  q, k, v, dout, lse, stats, out_a, out_b, b, lq, lk, hq, hkv, d, q_sb,  \
      q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, do_sb, do_sl,      \
      do_sh, causal, window, soft_cap, sm_scale

// The heads' partial dK (scaled) into out_a and dV into out_b, each
// (G, B, Lk, Hkv, D) f32 (G = 1: the gradients), from the stats that
// flash_attention_bwd_dq_f32 wrote
int flash_attention_bwd_dkdv_f32(BWD_PARAMS(float)) {
  BwdArgs<float> a;
  const int err = make_args(a, BWD_ARGS);
  if (err != 0) return (int)cudaErrorInvalidValue;
  return run_dkdv(a, blocks, stream);
}

// dQ into out_a, (B, Lq, Hq, D) f32, and the rows' lse' and delta into
// stats; out_b is not read
int flash_attention_bwd_dq_f32(BWD_PARAMS(float)) {
  BwdArgs<float> a;
  const int err = make_args(a, BWD_ARGS);
  if (err != 0) return err;
  return run_dq(a, blocks, stream);
}

// dK into dk and dV into dv, n elements each, from the partials (2, G, n)
// that flash_attention_bwd_dkdv_f32 wrote
int flash_attention_bwd_sum_f32(const float *part, float *dk, float *dv,
                                int64_t n, int g, int blocks, void *stream) {
  return run_sum(part, dk, dv, n, g, blocks, stream);
}

// The bf16 route: the same kernels on bf16 q, k, v and dO (see "bf16"
// above); the partials f32, dK and dV bf16 for G = 1
int flash_attention_bwd_dkdv_bf16(BWD_PARAMS(__nv_bfloat16)) {
  BwdArgs<__nv_bfloat16> a;
  const int err = make_args(a, BWD_ARGS);
  if (err != 0) return (int)cudaErrorInvalidValue;
  return run_dkdv(a, blocks, stream);
}

// dQ into out_a, (B, Lq, Hq, D) bf16, rounded once; the stats as in f32
int flash_attention_bwd_dq_bf16(BWD_PARAMS(__nv_bfloat16)) {
  BwdArgs<__nv_bfloat16> a;
  const int err = make_args(a, BWD_ARGS);
  if (err != 0) return err;
  return run_dq(a, blocks, stream);
}

// bf16 dK and dV, each the f32 partials (2, G, n) summed in head order and
// rounded once
int flash_attention_bwd_sum_bf16(const float *part, __nv_bfloat16 *dk,
                                 __nv_bfloat16 *dv, int64_t n, int g,
                                 int blocks, void *stream) {
  return run_sum(part, dk, dv, n, g, blocks, stream);
}

const char *flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
