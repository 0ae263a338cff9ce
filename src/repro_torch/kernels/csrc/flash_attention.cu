// Flash attention for NVIDIA Hopper (sm_90a), f32 or bf16 in and out, f32
// inside, hand-written CUDA.
//
// Replaces the TPU Pallas kernel _kernel of
// src/repro/kernels/flash_attention.py:31 (wrapper flash_attention, :106).
//
// Math.  For query row i of head h (absolute position q_pos = i + Lk - Lq:
// queries are right-aligned, so a continuation or a decode-like call sees
// the whole cache) and key j of KV head h / (Hq / Hkv):
//   s = (q . k) * (1 / sqrt(D));  s = cap * tanh(s / cap) when soft_cap > 0;
//   s = -1e30 unless j < Lk, (causal) q_pos >= j and (window) q_pos - j < W;
//   o = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-30),
// with the running max m and sum l kept in f32 across key tiles (the online
// softmax), exactly the recurrence of the TPU kernel: m starts at -1e30,
// and alpha = exp(m_old - m_new) rescales l and the output accumulator.
//
// Masked tiles.  The mask value is the finite -1e30 of the TPU kernel, not
// -INFINITY: a row whose first tile is fully masked gets p = exp(0) = 1 for
// every key there, which alpha = exp(-1e30 - m) = 0 wipes exactly when the
// first valid key arrives; with -INFINITY the same row would compute
// exp(-inf - -inf) = NaN.  A block skips the key tiles that are masked for
// all of its rows (causal: past the block's last query position; window:
// before its first position minus W).  Skipping leaves every output
// unchanged: such a tile adds exactly 0 after a row's first valid key and
// is wiped exactly before it.  The wrapper refuses causal calls with
// Lq > Lk, the only case that leaves a query row with no valid key.
//
// Rows.  A block owns (batch b, KV head, tile of query rows) where a row
// is one (query position, head of the GQA group) pair, taken
// position-major: row t is position t / G of head g = t % G, G = Hq / Hkv.
// All G query heads that read one KV head share the block, so each K/V
// tile is read from device memory once per block and serves all its rows:
// the fetch-once contract of the TPU kernel's BlockSpecs.  Any G works (10
// for recurrentgemma, 7 for llava) without padding heads.  The loop over
// key tiles inside the block takes the place of the TPU's sequential ik
// grid axis.  q, k, v and o are read and written in the JAX (B, L, H, D)
// layout through their strides (the head dim contiguous): no transposed or
// padded copy is made.
//
// What bounds it on the H100.  A layer of the qwen2.5-3b prefill (B = 2,
// L = 4096, Hq = 16, Hkv = 2, D = 128, causal) needs 4 D FLOPs a valid
// (query, key) pair, 137 GFLOP, against 67 MB of Q, K, V and O (0.02 ms
// at 3.35 TB/s): operations bound it.  The first design ran both products
// as f32 FMAs (67 TFLOP/s: 2.05 ms at the peak, 8.6 ms measured).
//
// Narrow route (D <= 256, flash_attention_kernel): both products on the
// TF32 tensor cores at f32 accuracy.  Each operand a is split into
// a_big = tf32(a) and a_small = tf32(a - a_big), rounded to nearest with
// ties away as cvt.rna.tf32.f32 rounds (two integer ops, where cvt takes
// four: the split is most of the kernel's non-tensor work), and each
// product is accumulated as (a_small b_big + a_big b_small) + a_big b_big
// in the f32 accumulators of warp-level mma.sync.m16n8k8 (3xTF32).  The
// dropped a_small b_small term and the rounding of the small halves leave
// ~2^-21 of each product, so the result stays within 1e-5 of the f32
// plain version, where one TF32 pass (2^-11) would not.  The bound of
// this route is 3 x FLOPs / 495 TFLOP/s (0.83 ms at the layer above).
// Warp w owns 16 query rows: S = Q K^T for a tile of kKeys keys is
// kKeys / 8 accumulator tiles of m16n8 (Q fragments read from shared
// memory a k-step at a time and split there, K fragments likewise); the
// online softmax runs on the accumulator registers, each row's max and
// sum reduced over the 4 lanes that hold it; P goes to O += P V straight
// from those registers: a lane holds keys 2t, 2t+1 of a row in the
// accumulator layout, and the A operand wants keys t, t+4, so the k index
// of the P V product is permuted (k = t reads key 2t, k = t + 4 key
// 2t + 1) and V's B fragments are read with the same permutation.
//
// Truncation.  The tensor cores align each mma's terms (the accumulator
// and the 8 products) to the largest and truncate as they add, so a long
// chain into one accumulator loses bits to its own running sum.  O shows
// it first: 3 x Lk / 8 truncated adds into it left 3e-5 of max|O| at
// Lk = 4096 (a 17-query continuation), against 1e-5 allowed; the scores
// of peaked logits (|s| ~ 2000 under qwen2.5-3b's JAX init) likewise
// carry a running sum far larger than two k-steps' products.  So each
// pair of k-steps goes into a fresh accumulator that is added to s in f32
// (round to nearest), and each key tile's P V into one that is added to
// O; there the small cross terms keep an accumulator of their own.  K/V
// tiles arrive through a two-stage cp.async ring: tile j + 1 is copied
// while tile j computes, one barrier a tile.  The head dim is zero-padded
// in shared memory to Dp = 64, 128 or 256 (a template parameter) so
// D = 12, 14, 16 (SMOKE configs), 128 and 256 all run; row stride Dp + 4
// floats keeps every fragment read free of bank conflicts.  Geometry:
// Dp 64 and 128: 8 warps, 128 rows, 64-key tiles (104 KB and 198 KB of
// shared memory); Dp 256: 4 warps, 64 rows, 32-key tiles (195 KB), so the
// 256-column output accumulator (128 registers a lane) fits.
//
// Wide heads.  D > 256 runs flash_attention_wide_kernel, the first
// design's f32 FFMA code: whole-D tiles would not fit 227 KB (Q, K and V
// of 64 rows at D = 320 take 252 KB), so there S = Q K^T walks D in
// chunks of kWideDs = 64 columns (Q and K chunks staged in turn, the
// scores' fmaf chains continued across chunks in ascending d), and a
// block accumulates kWideDo = 256 output columns: the grid gets
// ceil(D / 256) blocks per (row tile, KV head, batch), each recomputing
// the same scores and softmax (bitwise the same in every block) for its
// slice of P V.  Shared memory is 119 KB whatever D is, so every D runs;
// the scores are computed ceil(D / 256) times (2x at D = 320 and 512).
// Its threads are 16 x 16: thread (ty, tx) owns rows ty + 16 i (i < 4),
// score columns tx + 16 j (j < 4) of the 64 x 64 tile, and output
// columns 4 tx + 64 c + (0..3).
//
// bf16 (flash_attention_bf16).  The TPU kernel widens q, k and v to f32,
// computes S and P V in f32 and casts o once to q's dtype
// (flash_attention.py:44-45, :66, :73).  The same kernels run on bf16
// operands (the template's T): the Q tile and the K / V ring hold bf16,
// so a 16-byte cp.async carries 8 elements and a ring stage takes half
// the f32 bytes; everything after the products is f32.  On the narrow
// route the products run on the bf16 tensor cores, mma.sync m16n8k16
// (bf16_mma.cuh), not on TF32:
//   Q K^T: A = 16 Q rows x 16 d by ldmatrix.x4 from the Q tile, B = 16 d x
//     8 keys by non-transposed ldmatrix.x4 from the key-major K stage (d
//     contiguous: the mma's "col" B); a bf16 product is exact in f32.
//   P V: the C fragments of two adjacent n8 score tiles (keys 16 j ..
//     16 j + 15 of the tile) are the A fragment of one k16 step as they
//     stand (a lane holds keys 2t, 2t + 1 and 2t + 8, 2t + 9 of rows g and
//     g + 8), so no permutation of k and no shuffle is needed.  P is f32
//     in JAX, so each weight is split, p_hi = bf16_rn(p) and p_lo =
//     bf16_rn(p - p_hi) (p - p_hi is exact in f32), and both go against
//     the exact bf16 V (B by ldmatrix.x4.trans from the [key][d] stage):
//     p_hi + p_lo keeps p to within 2^-16 of |p| (bf16's unit roundoff
//     2^-8, twice), where one bf16 P would leave up to 2^-8.
// The fresh accumulator per pair of k-steps (32 d) for S and per key tile
// for P V (p_hi and p_lo each their own, added to O as hi + lo) is kept
// (see "Truncation"), and so is the lse output (f32).  Row stride Dp + 8
// elements: an odd count of 16-byte quads (Dp 64: 9, 128: 17, 256: 33), so
// no ldmatrix phase has a bank conflict; the tiles take 55,296, 104,448
// and 101,376 bytes of shared memory at Dp 64, 128 and 256.  o is rounded
// to bf16 once, at the store.  The wide route widens its tile loads and
// rounds at its store likewise.  The bound of the bf16 narrow route is its
// FLOPs over 989 TFLOP/s; its tensor-core work is FLOPs x 1.5 at that rate
// (Q K^T once, P V twice).
//
// Left for later: wgmma and TMA-fed K/V behind a producer warp, a key
// split for few-row calls (Lq = 17), the wide route on the tensor cores,
// the bf16 route on wgmma.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "cp_async.cuh"
#include "elem.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;   // wide kernel: 16 x 16
constexpr int kRows = 64;       // wide kernel: rows a block
constexpr int kKeys = 64;       // wide kernel: keys a tile
constexpr int kMaxNarrowDp = 256;   // larger D: the wide kernel
constexpr int kWideDs = 64;         // D columns of Q and K a chunk (wide)
constexpr int kWideDo = 256;        // output columns a block (wide)
constexpr float kNegInf = -1e30f;   // the TPU kernel's mask value
constexpr int kMaxSmemBytes = 232448;  // H100: 227 KB opt-in per block

template <typename T>
struct AttnArgs {
  const T *q, *k, *v;
  T *o;
  float *lse;           // (B, Hq, Lq) row log-sum-exp, or null: not written
  int lq, lk, hq, hkv, d, group;
  int64_t q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh;
  int64_t o_sb, o_sl, o_sh;
  int causal, window;   // window <= 0: none
  float soft_cap;       // <= 0: none
  float sm_scale;
  int row_tiles;
  int vec_kv;           // K and V rows copied 16 bytes at a time
};

// An element read through the read-only cache, and the zero of its type
__device__ __forceinline__ float ldg_elem(const float *p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 ldg_elem(const __nv_bfloat16 *p) {
  return __ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short *>(p)));
}
template <typename T>
__device__ __forceinline__ T zero_elem() {
  return T(0.f);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_elem<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}
// Two f32 weights (the lower k first) as bf16 pairs: hi = bf16_rn(x),
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

// Row padding of the shared tiles, in elements: 16 bytes, which keeps
// rows 16-byte aligned for cp.async and the fragment reads conflict-free
template <typename T>
constexpr int kRowPad = 16 / (int)sizeof(T);

template <typename T, int kDp, int kWarps, int kTileKeys>
constexpr size_t narrow_smem_bytes() {
  // Q tile and two stages of K and V tiles, rows of Dp + kRowPad elements
  return (size_t)(16 * kWarps + 4 * kTileKeys) * (kDp + kRowPad<T>) *
         sizeof(T);
}

template <typename T, int kDp, int kWarps, int kTileKeys>
__global__ void __launch_bounds__(kWarps * 32, 1)
    flash_attention_kernel(const AttnArgs<T> a) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kThr = kWarps * 32;
  constexpr int kBRows = 16 * kWarps;     // query rows a block
  constexpr int kS = kDp + kRowPad<T>;    // Q / K / V row stride (elements)
  constexpr int kNt = kTileKeys / 8;      // score tiles (8 keys) a warp
  constexpr int kOt = kDp / 8;            // output tiles (8 columns)
  constexpr int kKV = kTileKeys * kS;     // elements of one K or V tile
  constexpr int kVecE = 16 / (int)sizeof(T);   // elements a 16-byte copy
  extern __shared__ float4 smem4[];
  T *qs = reinterpret_cast<T *>(smem4);
  T *kvs = qs + kBRows * kS;              // [stage][K, V][key][d]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4; // mma group and thread-in-group
  // the last row tiles, the longest under a causal mask, start first
  const int tile = a.row_tiles - 1 - (int)blockIdx.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int g = a.group, n_rows = a.lq * g;
  const int t0 = tile * kBRows;
  const int off = a.lk - a.lq;            // right-aligned queries

  // Q tile: row r is (position (t0 + r) / G, head kvh * G + (t0 + r) % G)
  for (int e = tid; e < kBRows * kDp; e += kThr) {
    const int r = e / kDp, dd = e % kDp, t = t0 + r;
    T val = zero_elem<T>();
    if (t < n_rows && dd < a.d) {
      const int qi = t / g, h = kvh * g + t % g;
      val = ldg_elem(a.q + (int64_t)b * a.q_sb + (int64_t)qi * a.q_sl +
                     (int64_t)h * a.q_sh + dd);
    }
    qs[r * kS + dd] = val;
  }

  // this lane's rows: warp * 16 + gq (i = 0) and + 8 (i = 1)
  int q_pos[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + warp * 16 + gq + 8 * i;
    row_ok[i] = t < n_rows;
    q_pos[i] = t / g + off;
  }
  // key range of the block's rows (positions t0 / G .. last / G)
  const int last = min(t0 + kBRows, n_rows) - 1;
  const int pos_lo = t0 / g + off, pos_hi = last / g + off;
  int k_end = a.lk, k_begin = 0;
  if (a.causal) k_end = min(k_end, pos_hi + 1);
  if (a.window > 0) k_begin = max(0, pos_lo - a.window + 1);
  const int kt_begin = k_begin / kTileKeys;
  const int kt_end =
      k_end > k_begin ? (k_end + kTileKeys - 1) / kTileKeys : kt_begin;

  const T *kbase = a.k + (int64_t)b * a.k_sb + (int64_t)kvh * a.k_sh;
  const T *vbase = a.v + (int64_t)b * a.v_sb + (int64_t)kvh * a.v_sh;
  // K and V rows [k0, k0 + kTileKeys) into a stage, zeros past lk and d
  auto load = [&](int kt, int stage) {
    const int k0 = kt * kTileKeys;
    T *kd = kvs + stage * 2 * kKV, *vd = kd + kKV;
    if (a.vec_kv) {
      for (int e = tid; e < kTileKeys * kDp / kVecE; e += kThr) {
        const int r = e / (kDp / kVecE), c = kVecE * (e % (kDp / kVecE));
        const bool ok = k0 + r < a.lk && c < a.d;
        cp_async16(reinterpret_cast<float *>(kd + r * kS + c),
                   reinterpret_cast<const float *>(
                       ok ? kbase + (int64_t)(k0 + r) * a.k_sl + c : a.k),
                   ok);
        cp_async16(reinterpret_cast<float *>(vd + r * kS + c),
                   reinterpret_cast<const float *>(
                       ok ? vbase + (int64_t)(k0 + r) * a.v_sl + c : a.v),
                   ok);
      }
    } else {
      for (int e = tid; e < kTileKeys * kDp; e += kThr) {
        const int r = e / kDp, c = e % kDp;
        const bool ok = k0 + r < a.lk && c < a.d;
        if constexpr (kF32) {
          cp_async4(kd + r * kS + c,
                    ok ? kbase + (int64_t)(k0 + r) * a.k_sl + c : a.k, ok);
          cp_async4(vd + r * kS + c,
                    ok ? vbase + (int64_t)(k0 + r) * a.v_sl + c : a.v, ok);
        } else {
          // cp.async has no 2-byte copy: plain loads and stores, seen by
          // the other threads after the next tile's barrier
          kd[r * kS + c] =
              ok ? ldg_elem(kbase + (int64_t)(k0 + r) * a.k_sl + c)
                 : zero_elem<T>();
          vd[r * kS + c] =
              ok ? ldg_elem(vbase + (int64_t)(k0 + r) * a.v_sl + c)
                 : zero_elem<T>();
        }
      }
    }
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kOt][4];
#pragma unroll
  for (int j = 0; j < kOt; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  if (kt_begin < kt_end) load(kt_begin, 0);
  cp_async_commit();
  const T *qw = qs + warp * 16 * kS;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    cp_async_wait<0>();   // this thread's copies of tile kt
    __syncthreads();       // everyone's; the other stage is consumed
    if (kt + 1 < kt_end) load(kt + 1, stage ^ 1);
    cp_async_commit();
    const T *ks = kvs + stage * 2 * kKV, *vs = ks + kKV;
    const int k0 = kt * kTileKeys;

    // S = Q K^T: s[j] is the m16n8 tile of keys k0 + 8 j ..; a lane holds
    // (row gq, keys 2 tq, 2 tq + 1) in s[j][0..1] and row gq + 8 in [2..3]
    float s[kNt][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (kF32) {
#pragma unroll 1
      for (int d0 = 0; d0 < kDp; d0 += 16) {
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const T *qr = qw + gq * kS + d0 + 8 * h + tq;
          split_tf32(qr[0], ab[h][0], as[h][0]);
          split_tf32(qr[8 * kS], ab[h][1], as[h][1]);
          split_tf32(qr[4], ab[h][2], as[h][2]);
          split_tf32(qr[8 * kS + 4], ab[h][3], as[h][3]);
        }
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          // two k-steps into a fresh accumulator, added to s in f32 (see
          // "Truncation" above)
          float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const T *kr = ks + (8 * j + gq) * kS + d0 + 8 * h + tq;
            uint32_t bb[2], bs[2];
            split_tf32(kr[0], bb[0], bs[0]);
            split_tf32(kr[4], bb[1], bs[1]);
            mma_3xtf32(t, t, ab[h], as[h], bb, bs);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += t[e];
        }
      }
    } else {
      // bf16: a k-step is 16 d; two k-steps (32 d) into a fresh
      // accumulator per pair of score tiles, added to s in f32.  Q rows by
      // ldmatrix.x4 (lane: row (l & 7) + 8 ((l >> 3) & 1), d 8 (l >> 4));
      // K rows likewise, non-transposed (lane: key (l & 7) + 8 (l >> 4),
      // d 8 ((l >> 3) & 1)): b0 / b1 of score tiles 2 jj and 2 jj + 1
      const T *qa = qw + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kS +
                    8 * (lane >> 4);
      const T *ka = ks + ((lane & 7) + 8 * (lane >> 4)) * kS +
                    8 * ((lane >> 3) & 1);
#pragma unroll 1
      for (int d0 = 0; d0 < kDp; d0 += 32) {
        uint32_t af[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) ldsm_x4(qa + d0 + 16 * h, af[h]);
#pragma unroll
        for (int jj = 0; jj < kNt / 2; ++jj) {
          float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t kb[4];
            ldsm_x4(ka + 16 * jj * kS + d0 + 16 * h, kb);
            const uint32_t b0[2] = {kb[0], kb[1]}, b1[2] = {kb[2], kb[3]};
            mma_bf16(t0, af[h], b0);
            mma_bf16(t1, af[h], b1);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[2 * jj][e] += t0[e];
            s[2 * jj + 1][e] += t1[e];
          }
        }
      }
    }

    // scale, soft cap, mask; online softmax per row (4 lanes a row)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[j][2 * i + e] * a.sm_scale;
          if (a.soft_cap > 0.f) x = a.soft_cap * tanhf(x / a.soft_cap);
          const int kp = k0 + 8 * j + 2 * tq + e;
          bool ok = row_ok[i] && kp < a.lk;
          if (a.causal) ok = ok && q_pos[i] >= kp;
          if (a.window > 0) ok = ok && q_pos[i] - kp < a.window;
          s[j][2 * i + e] = ok ? x : kNegInf;
          mx = fmaxf(mx, s[j][2 * i + e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[j][2 * i + e] - m_new);
          s[j][2 * i + e] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOt; ++c) {
        o[c][2 * i] *= alpha;
        o[c][2 * i + 1] *= alpha;
      }
    }

    if constexpr (kF32) {
      // O += P V over 8 keys a k-step, k index permuted: A(row, k = tq) is
      // P(row, key 2 tq) and A(row, k = tq + 4) is P(row, key 2 tq + 1).
      // Each 8-column tile of O takes the tile's keys in a fresh
      // accumulator, added to O in f32 (round to nearest): the tensor
      // cores' accumulation truncates, and 3 x Lk / 8 truncated adds into
      // O itself would bias it by ~3e-5 of |O| at Lk = 4096.
      uint32_t pb[kNt][4], ps[kNt][4];
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        split_tf32(s[j][0], pb[j][0], ps[j][0]);
        split_tf32(s[j][2], pb[j][1], ps[j][1]);
        split_tf32(s[j][1], pb[j][2], ps[j][2]);
        split_tf32(s[j][3], pb[j][3], ps[j][3]);
      }
      const T *vr = vs + 2 * tq * kS + gq;
#pragma unroll
      for (int c = 0; c < kOt; ++c) {
        float t[4] = {0.f, 0.f, 0.f, 0.f}, tc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          uint32_t bb[2], bs[2];
          split_tf32(vr[8 * j * kS + 8 * c], bb[0], bs[0]);
          split_tf32(vr[(8 * j + 1) * kS + 8 * c], bb[1], bs[1]);
          mma_3xtf32(t, tc, pb[j], ps[j], bb, bs);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) o[c][e] += t[e] + tc[e];
      }
    } else {
      // O += P V over 16 keys a k-step: score tiles 2 jj and 2 jj + 1 are
      // the A fragment (a0, a1 from tile 2 jj's rows g, g + 8; a2, a3 from
      // tile 2 jj + 1's), split into p_hi and p_lo; V's B fragments of two
      // 8-column tiles by ldmatrix.x4.trans (lane: key (l & 7) + 8 ((l >> 3)
      // & 1), d 8 (l >> 4)).  Per key tile a fresh accumulator each for
      // p_hi V and p_lo V, added to O as hi + lo.
      uint32_t ph[kNt / 2][4], pl[kNt / 2][4];
#pragma unroll
      for (int jj = 0; jj < kNt / 2; ++jj)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float *src = s[2 * jj + (r >> 1)] + 2 * (r & 1);
          split_bf16(src[0], src[1], ph[jj][r], pl[jj][r]);
        }
      const T *va = vs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kS +
                    8 * (lane >> 4);
#pragma unroll
      for (int c2 = 0; c2 < kOt / 2; ++c2) {
        float th[2][4], tl[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) th[i][e] = tl[i][e] = 0.f;
#pragma unroll
        for (int jj = 0; jj < kNt / 2; ++jj) {
          uint32_t vb[2][2];
          ldsm_x4_trans(va + 16 * jj * kS + 16 * c2, vb[0], vb[1]);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(tl[i], pl[jj], vb[i]);
            mma_bf16(th[i], ph[jj], vb[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[2 * c2 + i][e] += th[i][e] + tl[i][e];
      }
    }
  }

  // o = acc / max(l, 1e-30), stored for d < D: o[c][2 i + e] is row
  // gq + 8 i, column 8 c + 2 tq + e
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + warp * 16 + gq + 8 * i;
    if (t >= n_rows) continue;
    const int qi = t / g, h = kvh * g + t % g;
    T *dst = a.o + (int64_t)b * a.o_sb + (int64_t)qi * a.o_sl +
             (int64_t)h * a.o_sh;
    const float den = fmaxf(l[i], 1e-30f);
    // the 4 lanes of a row hold the same m and l
    if (a.lse != nullptr && tq == 0)
      a.lse[((int64_t)b * a.hq + h) * a.lq + qi] = m[i] + logf(den);
#pragma unroll
    for (int c = 0; c < kOt; ++c) {
      const int d0 = 8 * c + 2 * tq;
      if (d0 < a.d) store_elem(dst + d0, o[c][2 * i] / den);
      if (d0 + 1 < a.d) store_elem(dst + d0 + 1, o[c][2 * i + 1] / den);
    }
  }
}

template <typename T, int kDp, int kWarps, int kTileKeys>
int launch(AttnArgs<T> a, int64_t rows, int b, void *stream) {
  constexpr size_t smem = narrow_smem_bytes<T, kDp, kWarps, kTileKeys>();
  static_assert(smem <= (size_t)kMaxSmemBytes, "tile exceeds shared memory");
  auto kernel = flash_attention_kernel<T, kDp, kWarps, kTileKeys>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  a.row_tiles = (int)((rows + 16 * kWarps - 1) / (16 * kWarps));
  const dim3 grid(a.row_tiles, a.hkv, b);
  kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// D > 256: S over D chunks of kWideDs, P V over kWideDo output columns a
// block (see "Wide heads" above).  The rows, the mask, the tile skip and
// the online softmax are the narrow kernel's.  Tiles are staged in f32
// (bf16 widened as it is loaded).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_wide_kernel(const AttnArgs<T> a) {
  constexpr int kS = kWideDs + 4;      // Q / K chunk row stride (floats)
  constexpr int kPStride = kKeys + 4;  // P row stride
  constexpr int kVStride = kWideDo + 4;
  constexpr int kDc = kWideDo / 64;    // float4 output columns a thread
  extern __shared__ float4 smem4[];
  float *qs = reinterpret_cast<float *>(smem4);
  float *ks = qs + kRows * kS;
  float *ps = ks + kKeys * kS;
  float *vs = ps + kRows * kPStride;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int o_chunks = (a.d + kWideDo - 1) / kWideDo;
  const int oc = (int)blockIdx.x % o_chunks;
  const int tile = a.row_tiles - 1 - (int)blockIdx.x / o_chunks;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int g = a.group, n_rows = a.lq * g;
  const int t0 = tile * kRows;
  const int off = a.lk - a.lq;
  const int dv0 = oc * kWideDo;        // first output column of the block

  int q_pos[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    row_ok[i] = t < n_rows;
    q_pos[i] = t / g + off;
  }
  const int last = min(t0 + kRows, n_rows) - 1;
  const int pos_lo = t0 / g + off, pos_hi = last / g + off;
  int k_end = a.lk, k_begin = 0;
  if (a.causal) k_end = min(k_end, pos_hi + 1);
  if (a.window > 0) k_begin = max(0, pos_lo - a.window + 1);
  const int kt_begin = k_begin / kKeys;
  const int kt_end = k_end > k_begin ? (k_end + kKeys - 1) / kKeys : kt_begin;

  float m[4], l[4];
  float4 acc[4][kDc];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDc; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const T *kbase = a.k + (int64_t)b * a.k_sb + (int64_t)kvh * a.k_sh;
  const T *vbase = a.v + (int64_t)b * a.v_sb + (int64_t)kvh * a.v_sh;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kKeys;
    // S = Q K^T, one fmaf chain over d a score, D in chunks
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < a.d; d0 += kWideDs) {
      __syncthreads();   // the previous chunk (and tile: P, V) is consumed
      for (int e = tid; e < kRows * kWideDs; e += kThreads) {
        const int r = e / kWideDs, dd = e % kWideDs, t = t0 + r;
        float qv = 0.f, kv = 0.f;
        if (t < n_rows && d0 + dd < a.d) {
          const int qi = t / g, h = kvh * g + t % g;
          qv = to_f32(ldg_elem(a.q + (int64_t)b * a.q_sb +
                               (int64_t)qi * a.q_sl + (int64_t)h * a.q_sh +
                               d0 + dd));
        }
        if (k0 + r < a.lk && d0 + dd < a.d)
          kv = to_f32(ldg_elem(kbase + (int64_t)(k0 + r) * a.k_sl + d0 + dd));
        qs[r * kS + dd] = qv;
        ks[r * kS + dd] = kv;
      }
      __syncthreads();
#pragma unroll 1
      for (int dd = 0; dd < kWideDs; dd += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4 *>(
              &qs[(ty + 16 * i) * kS + dd]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float4 *>(
              &ks[(tx + 16 * j) * kS + dd]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float t = s[i][j];
            t = fmaf(qv[i].x, kv[j].x, t);
            t = fmaf(qv[i].y, kv[j].y, t);
            t = fmaf(qv[i].z, kv[j].z, t);
            t = fmaf(qv[i].w, kv[j].w, t);
            s[i][j] = t;
          }
      }
    }

    // scale, soft cap, mask; online softmax per row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * a.sm_scale;
        if (a.soft_cap > 0.f) x = a.soft_cap * tanhf(x / a.soft_cap);
        const int kp = k0 + tx + 16 * j;
        bool ok = row_ok[i] && kp < a.lk;
        if (a.causal) ok = ok && q_pos[i] >= kp;
        if (a.window > 0) ok = ok && q_pos[i] - kp < a.window;
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDc; ++c) {
        acc[i][c].x *= alpha;
        acc[i][c].y *= alpha;
        acc[i][c].z *= alpha;
        acc[i][c].w *= alpha;
      }
    }

    // P and the block's V columns (the previous tile's P V finished
    // before the first barrier of this tile's D loop)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = s[i][j];
    for (int e = tid; e < kKeys * kWideDo; e += kThreads) {
      const int r = e / kWideDo, dd = e % kWideDo;
      float val = 0.f;
      if (k0 + r < a.lk && dv0 + dd < a.d)
        val = to_f32(ldg_elem(vbase + (int64_t)(k0 + r) * a.v_sl + dv0 + dd));
      vs[r * kVStride + dd] = val;
    }
    __syncthreads();

    // O += P V
#pragma unroll 1
    for (int c0 = 0; c0 < kKeys; c0 += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4 *>(
            &ps[(ty + 16 * i) * kPStride + c0]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int c = 0; c < kDc; ++c) {
          const float4 vv = *reinterpret_cast<const float4 *>(
              &vs[(c0 + cc) * kVStride + 4 * tx + 64 * c]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0   ? pv[i].x
                            : cc == 1 ? pv[i].y
                            : cc == 2 ? pv[i].z
                                      : pv[i].w;
            acc[i][c].x = fmaf(p, vv.x, acc[i][c].x);
            acc[i][c].y = fmaf(p, vv.y, acc[i][c].y);
            acc[i][c].z = fmaf(p, vv.z, acc[i][c].z);
            acc[i][c].w = fmaf(p, vv.w, acc[i][c].w);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= n_rows) continue;
    const int qi = t / g, h = kvh * g + t % g;
    T *dst = a.o + (int64_t)b * a.o_sb + (int64_t)qi * a.o_sl +
             (int64_t)h * a.o_sh;
    const float den = fmaxf(l[i], 1e-30f);
    // every block of the row's output chunks, and every lane of the row,
    // holds the same m and l: the first writes lse
    if (a.lse != nullptr && tx == 0 && oc == 0)
      a.lse[((int64_t)b * a.hq + h) * a.lq + qi] = m[i] + logf(den);
#pragma unroll
    for (int c = 0; c < kDc; ++c) {
      const int d0 = dv0 + 4 * tx + 64 * c;
      const float vals[4] = {acc[i][c].x, acc[i][c].y, acc[i][c].z,
                             acc[i][c].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d0 + e < a.d) store_elem(dst + d0 + e, vals[e] / den);
    }
  }
}

template <typename T>
int launch_wide(AttnArgs<T> a, int64_t rows, int b, void *stream) {
  constexpr size_t smem =
      ((size_t)(kRows + kKeys) * (kWideDs + 4) + (size_t)kRows * (kKeys + 4) +
       (size_t)kKeys * (kWideDo + 4)) * sizeof(float);
  static_assert(smem <= (size_t)kMaxSmemBytes, "tile exceeds shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wide_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  a.row_tiles = (int)((rows + kRows - 1) / kRows);
  const int64_t blocks = (int64_t)a.row_tiles * ((a.d + kWideDo - 1) / kWideDo);
  if (blocks > 2147483647) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, a.hkv, b);
  flash_attention_wide_kernel<T><<<grid, kThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Checks the geometry, fills the arguments and launches the route of D.
template <typename T>
int run(const T *q, const T *k, const T *v, T *o, float *lse, int b, int lq,
        int lk, int hq, int hkv, int d, int64_t q_sb, int64_t q_sl,
        int64_t q_sh, int64_t k_sb, int64_t k_sl, int64_t k_sh, int64_t v_sb,
        int64_t v_sl, int64_t v_sh, int64_t o_sb, int64_t o_sl, int64_t o_sh,
        int causal, int window, float soft_cap, float sm_scale,
        void *stream) {
  if (b < 1 || lq < 1 || lk < 1 || hkv < 1 || hq < hkv || hq % hkv != 0 ||
      d < 1 || (causal && lq > lk) || b > 65535 ||
      hkv > 65535)
    return (int)cudaErrorInvalidValue;
  AttnArgs<T> a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = lse;
  a.lq = lq; a.lk = lk; a.hq = hq; a.hkv = hkv; a.d = d;
  a.group = hq / hkv;
  a.q_sb = q_sb; a.q_sl = q_sl; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_sl = k_sl; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_sl = v_sl; a.v_sh = v_sh;
  a.o_sb = o_sb; a.o_sl = o_sl; a.o_sh = o_sh;
  a.causal = causal; a.window = window; a.soft_cap = soft_cap;
  a.sm_scale = sm_scale;
  const int64_t rows = (int64_t)lq * a.group;
  if (rows > (int64_t)1 << 30) return (int)cudaErrorInvalidValue;
  a.row_tiles = 0;
  const auto al16 = [](const void *p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  constexpr int kV = 16 / (int)sizeof(T);   // elements a 16-byte copy
  a.vec_kv = d % kV == 0 && al16(k) && al16(v) && k_sb % kV == 0 &&
             k_sl % kV == 0 && k_sh % kV == 0 && v_sb % kV == 0 &&
             v_sl % kV == 0 && v_sh % kV == 0;
  if (d <= 64) return launch<T, 64, 8, 64>(a, rows, b, stream);
  if (d <= 128) return launch<T, 128, 8, 64>(a, rows, b, stream);
  if (d <= kMaxNarrowDp) return launch<T, 256, 4, 32>(a, rows, b, stream);
  return launch_wide<T>(a, rows, b, stream);
}

}  // namespace

// C entry point, bound with ctypes by repro_torch/kernels/build.py.  It
// launches on `stream` without synchronising and returns cudaGetLastError()
// (or cudaErrorInvalidValue for a geometry the kernel cannot take).
// Strides are in elements; the head dim must be contiguous.  A non-null
// `lse` (contiguous (B, Hq, Lq)) receives each row's log-sum-exp
// m + log(max(l, 1e-30)), which the backward kernels of
// flash_attention_bwd.cu read; o is the same with or without it.
extern "C" {

int flash_attention_f32(const float *q, const float *k, const float *v,
                        float *o, float *lse, int b, int lq, int lk, int hq,
                        int hkv, int d, int64_t q_sb, int64_t q_sl,
                        int64_t q_sh,
                        int64_t k_sb, int64_t k_sl, int64_t k_sh,
                        int64_t v_sb, int64_t v_sl, int64_t v_sh,
                        int64_t o_sb, int64_t o_sl, int64_t o_sh, int causal,
                        int window, float soft_cap, float sm_scale,
                        void *stream) {
  return run<float>(q, k, v, o, lse, b, lq, lk, hq, hkv, d, q_sb, q_sl,
                    q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, o_sb, o_sl,
                    o_sh, causal, window, soft_cap, sm_scale, stream);
}

// bf16 q, k, v and o, f32 inside (see "bf16" above); lse stays f32.
int flash_attention_bf16(const __nv_bfloat16 *q, const __nv_bfloat16 *k,
                         const __nv_bfloat16 *v, __nv_bfloat16 *o,
                         float *lse, int b, int lq, int lk, int hq, int hkv,
                         int d, int64_t q_sb, int64_t q_sl, int64_t q_sh,
                         int64_t k_sb, int64_t k_sl, int64_t k_sh,
                         int64_t v_sb, int64_t v_sl, int64_t v_sh,
                         int64_t o_sb, int64_t o_sl, int64_t o_sh,
                         int causal, int window, float soft_cap,
                         float sm_scale, void *stream) {
  return run<__nv_bfloat16>(q, k, v, o, lse, b, lq, lk, hq, hkv, d, q_sb,
                            q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh,
                            o_sb, o_sl, o_sh, causal, window, soft_cap,
                            sm_scale, stream);
}

const char *flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
