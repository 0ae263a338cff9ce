// The backward of flash attention for NVIDIA Hopper (sm_90a), f32, hand-
// written CUDA: FlashAttention-2's backward, in two kernels.
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
// Row statistics.  The backward forms its scores with f32 FFMA chains,
// the forward's narrow route with 3xTF32 products; at the peaked logits
// of a full-width LM (|y| ~ 2000 under the JAX initialiser) the two differ
// by ~1e-3 in the exponent.  With p = exp(y - lse) from the forward's lse
// and delta = rowsum(dO o O) from its O, a saturated row's P would sum to
// 1 + 1e-3 and its dS, which is ~0 in exact arithmetic, would keep a
// spurious part of that size: one layer's attention gradient at those
// logits then read up to 18x the f32 ref oracle's error from float64
// (1.3x with the statistics below; chip_smoke.py's LM train phase on an
// H100).  So the dQ kernel's first pass takes each
// row's statistics from the backward's own scores, with the forward's
// lse = m + log(max(l, 1e-30)) (written by flash_attention_f32 when it is
// given an lse pointer) as the reference point that keeps the exponents
// in range:  e = exp(y - lse),  l' = sum e,  lse' = lse + log l',
// delta = sum e dP / l'.  Then p = exp(y - lse') sums to 1 over the row,
// and dS is that of an exact softmax of the recomputed scores.  The dQ
// kernel writes lse' and delta for the dK / dV kernel, which runs after
// it.  The forward's O is not read.
//
// Rows.  As in the forward, a row is one (query position, head of the
// GQA group) pair, position-major: row t is position t / G of head
// kvh * G + t % G.  So the G query heads that read one KV head fall into
// the same row tiles, and their contributions to dK and dV sum inside
// one block: no float atomics, and two launches give the same bits.
//
// flash_attention_bwd_dkdv_kernel: one block per (key tile of kKeys keys,
// KV head, batch).  K and V of the tile stay in shared memory; the block
// walks the row tiles that can see the tile (causal: positions at or
// after its first key; window: up to its last key + W - 1), each step
// recomputing S and dP for kRows x kKeys pairs, then adding P^T dO and
// dS^T Q into register accumulators (thread (ty, tx) owns keys ty + 16 i
// and columns 4 tx + 64 c .. + 3).
//
// flash_attention_bwd_dq_kernel: one block per (row tile of kRows rows,
// KV head, batch), Q and dO of the tile resident; it walks the key tiles
// its rows see (the forward's range) twice: first for the rows'
// statistics (each thread's partial sums over its keys, then summed over
// the 16 threads of a row in order through shared memory), then adding
// dS K into register accumulators (rows ty + 16 i, the same columns).
//
// Both form S and dP with tile_products: thread (ty, tx) of the 16 x 16
// block forms the scores of rows ty + 16 i and keys tx + 16 j as fmaf
// chains over d in ascending order.  The head dim is zero-padded in
// shared memory to Dp = 64, 128 or 256 (a template parameter), rows at a
// stride of Dp + 4 floats; the chains run over ceil(D / 4) float4 steps.
//
// What bounds it on the H100.  The backward needs 10 D FLOPs a valid
// pair at the least (S, dP, dV, dK, dQ; 2.5 x the forward's 4 D); this
// design does 18 D (S and dP are formed three times: twice in the dQ
// kernel, once in the dK / dV kernel): dkdv 8 D, dq 10 D.  At the
// training shape (B 2, L 1024, Hq 16, Hkv 2, D 128, causal) that is 21.5
// GFLOP at the least against 42 MB of Q, K, V, O, dO and the gradients:
// operations bound it, 0.32 ms at 67 TFLOP/s f32 FFMA.  This
// first design is FFMA only (no tensor cores), with plain loads staged
// through shared memory between barriers.  Left for later: 3xTF32 on
// mma.sync as the forward's narrow route does, a cp.async ring, a split
// of the dkdv rows for few-key-tile grids, and the wide route (D > 256).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // 16 x 16
constexpr int kMaxDp = 256;            // the forward's narrow route
constexpr int kMaxSmemBytes = 232448;  // H100: 227 KB opt-in per block

struct BwdArgs {
  const float *q, *k, *v, *dout;
  const float *lse;       // the forward's (B, Hq, Lq), read by dq
  float *stats;           // (2, B, Hq, Lq): lse' and delta, dq -> dkdv
  float *out_a, *out_b;   // dkdv: dK, dV; dq: dQ (contiguous B, L, H, D)
  int lq, lk, hq, hkv, d, d4, group;
  int64_t q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh;
  int64_t do_sb, do_sl, do_sh;
  int causal, window;     // window <= 0: none
  float soft_cap;         // <= 0: none
  float sm_scale;
  int tiles;              // dkdv: key tiles; dq: row tiles
};

template <int kDp, int kRows, int kKeys>
constexpr size_t bwd_smem_bytes() {
  // Q, dO (kRows rows), K, V (kKeys rows), P and dS (kRows x kKeys + 4),
  // lse and delta of the rows
  return ((size_t)(2 * kRows + 2 * kKeys) * (kDp + 4) +
          (size_t)2 * kRows * (kKeys + 4) + 2 * kRows) * sizeof(float);
}

// Q and dO of rows [t0, t0 + kRows) (zeros past the last row and past
// d), and each row's entry of lse and of delta (zeros where delta is null)
template <int kDp, int kRows>
__device__ __forceinline__ void load_rows(const BwdArgs &a, int b, int kvh,
                                          int t0, const float *lse,
                                          const float *delta, float *qs,
                                          float *dos, float *ls,
                                          float *dls) {
  constexpr int kS = kDp + 4;
  const int g = a.group, n_rows = a.lq * g;
  for (int e = threadIdx.x; e < kRows * kDp; e += kThreads) {
    const int r = e / kDp, dd = e % kDp, t = t0 + r;
    float qv = 0.f, ov = 0.f;
    if (t < n_rows && dd < a.d) {
      const int qi = t / g, h = kvh * g + t % g;
      qv = __ldg(a.q + (int64_t)b * a.q_sb + (int64_t)qi * a.q_sl +
                 (int64_t)h * a.q_sh + dd);
      ov = __ldg(a.dout + (int64_t)b * a.do_sb + (int64_t)qi * a.do_sl +
                 (int64_t)h * a.do_sh + dd);
    }
    qs[r * kS + dd] = qv;
    dos[r * kS + dd] = ov;
  }
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const int t = t0 + r;
    float lv = 0.f, dv = 0.f;
    if (t < n_rows) {
      const int qi = t / g, h = kvh * g + t % g;
      const int64_t idx = ((int64_t)b * a.hq + h) * a.lq + qi;
      lv = __ldg(lse + idx);
      if (delta != nullptr) dv = __ldg(delta + idx);
    }
    ls[r] = lv;
    dls[r] = dv;
  }
}

// K and V of keys [k0, k0 + kKeys), zeros past lk and d
template <int kDp, int kKeys>
__device__ __forceinline__ void load_keys(const BwdArgs &a, int b, int kvh,
                                          int k0, float *ks, float *vs) {
  constexpr int kS = kDp + 4;
  const float *kbase = a.k + (int64_t)b * a.k_sb + (int64_t)kvh * a.k_sh;
  const float *vbase = a.v + (int64_t)b * a.v_sb + (int64_t)kvh * a.v_sh;
  for (int e = threadIdx.x; e < kKeys * kDp; e += kThreads) {
    const int r = e / kDp, dd = e % kDp;
    float kv = 0.f, vv = 0.f;
    if (k0 + r < a.lk && dd < a.d) {
      kv = __ldg(kbase + (int64_t)(k0 + r) * a.k_sl + dd);
      vv = __ldg(vbase + (int64_t)(k0 + r) * a.v_sl + dd);
    }
    ks[r * kS + dd] = kv;
    vs[r * kS + dd] = vv;
  }
}

// S = Q K^T and dP = dO V^T of rows [t0, t0 + kRows) x keys [k0, k0 +
// kKeys) in registers: thread (ty, tx) forms rows ty + 16 i, keys
// tx + 16 j, each an fmaf chain over d in ascending order.
template <int kDp, int kRI, int kCJ>
__device__ __forceinline__ void tile_products(const BwdArgs &a,
                                              const float *qs,
                                              const float *dos,
                                              const float *ks,
                                              const float *vs,
                                              float (&s)[kRI][kCJ],
                                              float (&dp)[kRI][kCJ]) {
  constexpr int kS = kDp + 4;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < kRI; ++i)
#pragma unroll
    for (int j = 0; j < kCJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 1
  for (int dd = 0; dd < a.d4; dd += 4) {
    float4 qv[kRI], ov[kRI], kv[kCJ], vv[kCJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      qv[i] = *reinterpret_cast<const float4 *>(&qs[(ty + 16 * i) * kS + dd]);
      ov[i] = *reinterpret_cast<const float4 *>(&dos[(ty + 16 * i) * kS + dd]);
    }
#pragma unroll
    for (int j = 0; j < kCJ; ++j) {
      kv[j] = *reinterpret_cast<const float4 *>(&ks[(tx + 16 * j) * kS + dd]);
      vv[j] = *reinterpret_cast<const float4 *>(&vs[(tx + 16 * j) * kS + dd]);
    }
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        float t = s[i][j], u = dp[i][j];
        t = fmaf(qv[i].x, kv[j].x, t);
        t = fmaf(qv[i].y, kv[j].y, t);
        t = fmaf(qv[i].z, kv[j].z, t);
        t = fmaf(qv[i].w, kv[j].w, t);
        u = fmaf(ov[i].x, vv[j].x, u);
        u = fmaf(ov[i].y, vv[j].y, u);
        u = fmaf(ov[i].z, vv[j].z, u);
        u = fmaf(ov[i].w, vv[j].w, u);
        s[i][j] = t;
        dp[i][j] = u;
      }
  }
}

// The scaled, capped score y of a raw product s, and (in chain) the cap's
// derivative 1 - tanh^2 (1 without a cap)
__device__ __forceinline__ float capped(const BwdArgs &a, float s,
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

// Whether row t (position-major) sees key kp
__device__ __forceinline__ bool valid_pair(const BwdArgs &a, int t, int kp) {
  const int q_pos = t / a.group + a.lk - a.lq;
  bool ok = t < a.lq * a.group && kp < a.lk;
  if (a.causal) ok = ok && q_pos >= kp;
  if (a.window > 0) ok = ok && q_pos - kp < a.window;
  return ok;
}

// P (where ps is given) and dS of rows [t0, t0 + kRows) x keys
// [k0, k0 + kKeys) into shared memory, row stride kKeys + 4, from the
// rows' lse' (ls) and delta (dls).  dS is the gradient of the scaled,
// capped score y; the caller applies sm_scale once to its sums.
template <int kDp, int kRows, int kKeys>
__device__ __forceinline__ void score_tile(const BwdArgs &a, int t0, int k0,
                                           const float *qs, const float *dos,
                                           const float *ks, const float *vs,
                                           const float *ls, const float *dls,
                                           float *ps, float *dss) {
  constexpr int kPS = kKeys + 4, kRI = kRows / 16, kCJ = kKeys / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[kRI][kCJ], dp[kRI][kCJ];
  tile_products<kDp, kRI, kCJ>(a, qs, dos, ks, vs, s, dp);
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int r = ty + 16 * i;
    const float lse = ls[r], delta = dls[r];
#pragma unroll
    for (int j = 0; j < kCJ; ++j) {
      const int c = tx + 16 * j;
      float chain;
      const float y = capped(a, s[i][j], chain);
      const float p = valid_pair(a, t0 + r, k0 + c) ? expf(y - lse) : 0.f;
      if (ps != nullptr) ps[r * kPS + c] = p;
      dss[r * kPS + c] = p * (dp[i][j] - delta) * chain;
    }
  }
}

template <int kDp, int kRows, int kKeys>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dkdv_kernel(const BwdArgs a) {
  constexpr int kS = kDp + 4, kPS = kKeys + 4;
  constexpr int kKI = kKeys / 16, kDc = kDp / 64;
  extern __shared__ float4 smem4[];
  float *qs = reinterpret_cast<float *>(smem4);
  float *dos = qs + kRows * kS;
  float *ks = dos + kRows * kS;
  float *vs = ks + kKeys * kS;
  float *ps = vs + kKeys * kS;
  float *dss = ps + kRows * kPS;
  float *ls = dss + kRows * kPS;
  float *dls = ls + kRows;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  // key tile 0, the longest under a causal mask, starts first
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g = a.group, off = a.lk - a.lq;
  const int k0 = kt * kKeys, k1 = min(k0 + kKeys, a.lk);

  // the query positions that see a key of [k0, k1)
  int qi_lo = 0, qi_hi = a.lq - 1;
  if (a.causal) qi_lo = max(qi_lo, k0 - off);
  if (a.window > 0) qi_hi = min(qi_hi, k1 - 1 + a.window - 1 - off);
  const int t_lo = qi_lo * g, t_hi = (qi_hi + 1) * g;   // rows, exclusive

  load_keys<kDp, kKeys>(a, b, kvh, k0, ks, vs);
  float dk[kKI][kDc][4], dv[kKI][kDc][4];
#pragma unroll
  for (int i = 0; i < kKI; ++i)
#pragma unroll
    for (int c = 0; c < kDc; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][c][e] = dv[i][c][e] = 0.f;

  for (int t0 = t_lo / kRows * kRows; t0 < t_hi; t0 += kRows) {
    __syncthreads();   // the previous tile's rows, P and dS are consumed
    const int64_t n_stats = (int64_t)gridDim.z * a.hq * a.lq;
    load_rows<kDp, kRows>(a, b, kvh, t0, a.stats, a.stats + n_stats, qs,
                          dos, ls, dls);
    __syncthreads();
    score_tile<kDp, kRows, kKeys>(a, t0, k0, qs, dos, ks, vs, ls, dls, ps,
                                  dss);
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q over the tile's rows in order
#pragma unroll 1
    for (int r = 0; r < kRows; ++r) {
      float4 ov[kDc], qv[kDc];
#pragma unroll
      for (int c = 0; c < kDc; ++c) {
        const int col = r * kS + 4 * tx + 64 * c;
        ov[c] = *reinterpret_cast<const float4 *>(&dos[col]);
        qv[c] = *reinterpret_cast<const float4 *>(&qs[col]);
      }
#pragma unroll
      for (int i = 0; i < kKI; ++i) {
        const float p = ps[r * kPS + ty + 16 * i];
        const float ds = dss[r * kPS + ty + 16 * i];
#pragma unroll
        for (int c = 0; c < kDc; ++c) {
          dv[i][c][0] = fmaf(p, ov[c].x, dv[i][c][0]);
          dv[i][c][1] = fmaf(p, ov[c].y, dv[i][c][1]);
          dv[i][c][2] = fmaf(p, ov[c].z, dv[i][c][2]);
          dv[i][c][3] = fmaf(p, ov[c].w, dv[i][c][3]);
          dk[i][c][0] = fmaf(ds, qv[c].x, dk[i][c][0]);
          dk[i][c][1] = fmaf(ds, qv[c].y, dk[i][c][1]);
          dk[i][c][2] = fmaf(ds, qv[c].z, dk[i][c][2]);
          dk[i][c][3] = fmaf(ds, qv[c].w, dk[i][c][3]);
        }
      }
    }
  }

  // dK (scaled) and dV, contiguous (B, Lk, Hkv, D)
#pragma unroll
  for (int i = 0; i < kKI; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= a.lk) continue;
    const int64_t base = (((int64_t)b * a.lk + kp) * a.hkv + kvh) * a.d;
#pragma unroll
    for (int c = 0; c < kDc; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tx + 64 * c + e;
        if (col < a.d) {
          a.out_a[base + col] = dk[i][c][e] * a.sm_scale;
          a.out_b[base + col] = dv[i][c][e];
        }
      }
  }
}

template <int kDp, int kRows, int kKeys>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dq_kernel(const BwdArgs a) {
  constexpr int kS = kDp + 4, kPS = kKeys + 4;
  constexpr int kRI = kRows / 16, kDc = kDp / 64;
  extern __shared__ float4 smem4[];
  float *qs = reinterpret_cast<float *>(smem4);
  float *dos = qs + kRows * kS;
  float *ks = dos + kRows * kS;
  float *vs = ks + kKeys * kS;
  float *dss = vs + kKeys * kS;
  float *ls = dss + kRows * kPS;
  float *dls = ls + kRows;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  // the last row tiles, the longest under a causal mask, start first
  const int tile = a.tiles - 1 - (int)blockIdx.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int g = a.group, n_rows = a.lq * g, off = a.lk - a.lq;
  const int t0 = tile * kRows;

  // the forward's key range of the tile's rows
  const int last = min(t0 + kRows, n_rows) - 1;
  const int pos_lo = t0 / g + off, pos_hi = last / g + off;
  int k_end = a.lk, k_begin = 0;
  if (a.causal) k_end = min(k_end, pos_hi + 1);
  if (a.window > 0) k_begin = max(0, pos_lo - a.window + 1);
  const int kt_begin = k_begin / kKeys;
  const int kt_end = k_end > k_begin ? (k_end + kKeys - 1) / kKeys : kt_begin;

  load_rows<kDp, kRows>(a, b, kvh, t0, a.lse, nullptr, qs, dos, ls, dls);

  // pass 1: the rows' statistics under this kernel's scores (see "Row
  // statistics" above): e = exp(y - lse), l' = sum e, t' = sum e dP
  float lp[kRI], tp[kRI];
#pragma unroll
  for (int i = 0; i < kRI; ++i) lp[i] = tp[i] = 0.f;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    __syncthreads();   // the previous tile's K and V are consumed
    load_keys<kDp, kKeys>(a, b, kvh, kt * kKeys, ks, vs);
    __syncthreads();
    float s[kRI][kKeys / 16], dp[kRI][kKeys / 16];
    tile_products<kDp, kRI, kKeys / 16>(a, qs, dos, ks, vs, s, dp);
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kKeys / 16; ++j) {
        float chain;
        const float y = capped(a, s[i][j], chain);
        if (valid_pair(a, t0 + ty + 16 * i, kt * kKeys + tx + 16 * j)) {
          const float e = expf(y - ls[ty + 16 * i]);
          lp[i] += e;
          tp[i] = fmaf(e, dp[i][j], tp[i]);
        }
      }
  }
  // each row's 16 partial sums, added in thread order: lse' and delta
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    dss[(ty + 16 * i) * kPS + tx] = lp[i];
    dss[(ty + 16 * i) * kPS + 16 + tx] = tp[i];
  }
  __syncthreads();
  const int64_t n_stats = (int64_t)gridDim.z * a.hq * a.lq;
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    float l2 = 0.f, t2 = 0.f;
    for (int x = 0; x < 16; ++x) {
      l2 += dss[r * kPS + x];
      t2 += dss[r * kPS + 16 + x];
    }
    const int t = t0 + r;
    float lse2 = 0.f, delta = 0.f;   // rows past the last: never read
    if (t < n_rows && l2 > 0.f) {
      lse2 = ls[r] + logf(l2);
      delta = t2 / l2;
      const int qi = t / g, h = kvh * g + t % g;
      const int64_t idx = ((int64_t)b * a.hq + h) * a.lq + qi;
      a.stats[idx] = lse2;
      a.stats[n_stats + idx] = delta;
    }
    ls[r] = lse2;
    dls[r] = delta;
  }

  // pass 2: dQ
  float dq[kRI][kDc][4];
#pragma unroll
  for (int i = 0; i < kRI; ++i)
#pragma unroll
    for (int c = 0; c < kDc; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[i][c][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    __syncthreads();   // the previous tile's K, V and dS are consumed
    load_keys<kDp, kKeys>(a, b, kvh, kt * kKeys, ks, vs);
    __syncthreads();
    score_tile<kDp, kRows, kKeys>(a, t0, kt * kKeys, qs, dos, ks, vs, ls,
                                  dls, nullptr, dss);
    __syncthreads();
    // dQ += dS K over the tile's keys in order
#pragma unroll 1
    for (int c0 = 0; c0 < kKeys; ++c0) {
      float4 kv[kDc];
#pragma unroll
      for (int c = 0; c < kDc; ++c)
        kv[c] = *reinterpret_cast<const float4 *>(
            &ks[c0 * kS + 4 * tx + 64 * c]);
#pragma unroll
      for (int i = 0; i < kRI; ++i) {
        const float ds = dss[(ty + 16 * i) * kPS + c0];
#pragma unroll
        for (int c = 0; c < kDc; ++c) {
          dq[i][c][0] = fmaf(ds, kv[c].x, dq[i][c][0]);
          dq[i][c][1] = fmaf(ds, kv[c].y, dq[i][c][1]);
          dq[i][c][2] = fmaf(ds, kv[c].z, dq[i][c][2]);
          dq[i][c][3] = fmaf(ds, kv[c].w, dq[i][c][3]);
        }
      }
    }
  }

  // dQ (scaled), contiguous (B, Lq, Hq, D)
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= n_rows) continue;
    const int qi = t / g, h = kvh * g + t % g;
    const int64_t base = (((int64_t)b * a.lq + qi) * a.hq + h) * a.d;
#pragma unroll
    for (int c = 0; c < kDc; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tx + 64 * c + e;
        if (col < a.d) a.out_a[base + col] = dq[i][c][e] * a.sm_scale;
      }
  }
}

template <int kDp, int kRows, int kKeys>
int launch_dkdv(BwdArgs a, int b, void *stream) {
  constexpr size_t smem = bwd_smem_bytes<kDp, kRows, kKeys>();
  static_assert(smem <= (size_t)kMaxSmemBytes, "tile exceeds shared memory");
  auto kernel = flash_attention_bwd_dkdv_kernel<kDp, kRows, kKeys>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  a.tiles = (a.lk + kKeys - 1) / kKeys;
  const dim3 grid(a.tiles, a.hkv, b);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

template <int kDp, int kRows, int kKeys>
int launch_dq(BwdArgs a, int b, void *stream) {
  constexpr size_t smem = bwd_smem_bytes<kDp, kRows, kKeys>();
  static_assert(smem <= (size_t)kMaxSmemBytes, "tile exceeds shared memory");
  auto kernel = flash_attention_bwd_dq_kernel<kDp, kRows, kKeys>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t rows = (int64_t)a.lq * a.group;
  const int64_t tiles = (rows + kRows - 1) / kRows;
  if (tiles > 2147483647) return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  const dim3 grid((unsigned)tiles, a.hkv, b);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The argument checks and the struct both entry points share; returns
// cudaErrorInvalidValue for a geometry the kernels cannot take
int make_args(BwdArgs &a, const float *q, const float *k, const float *v,
              const float *dout, const float *lse, float *stats,
              float *out_a, float *out_b, int b, int lq, int lk, int hq,
              int hkv, int d, int64_t q_sb, int64_t q_sl, int64_t q_sh,
              int64_t k_sb, int64_t k_sl, int64_t k_sh, int64_t v_sb,
              int64_t v_sl, int64_t v_sh, int64_t do_sb, int64_t do_sl,
              int64_t do_sh, int causal, int window, float soft_cap,
              float sm_scale) {
  if (b < 1 || lq < 1 || lk < 1 || hkv < 1 || hq < hkv || hq % hkv != 0 ||
      d < 1 || d > kMaxDp || (causal && lq > lk) || b > 65535 ||
      hkv > 65535 || (int64_t)lq * (hq / hkv) > ((int64_t)1 << 30))
    return (int)cudaErrorInvalidValue;
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.stats = stats;
  a.out_a = out_a; a.out_b = out_b;
  a.lq = lq; a.lk = lk; a.hq = hq; a.hkv = hkv; a.d = d;
  a.d4 = (d + 3) / 4 * 4;
  a.group = hq / hkv;
  a.q_sb = q_sb; a.q_sl = q_sl; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_sl = k_sl; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_sl = v_sl; a.v_sh = v_sh;
  a.do_sb = do_sb; a.do_sl = do_sl; a.do_sh = do_sh;
  a.causal = causal; a.window = window; a.soft_cap = soft_cap;
  a.sm_scale = sm_scale;
  a.tiles = 0;
  return 0;
}

}  // namespace

// C entry points, bound with ctypes by repro_torch/kernels/build.py.  Each
// launches on `stream` without synchronising and returns cudaGetLastError()
// (or cudaErrorInvalidValue for a geometry the kernels cannot take: D >
// 256 has no backward here).  q, k, v and dO are read through their
// strides (in elements; the head dim contiguous); lse (the forward's) is
// contiguous (B, Hq, Lq) and stats (2, B, Hq, Lq); the gradients are
// written contiguous.  Launch dq first: it writes the stats dkdv reads.
extern "C" {

#define BWD_PARAMS                                                          \
  const float *q, const float *k, const float *v, const float *dout,       \
      const float *lse, float *stats, float *out_a, float *out_b,          \
      int b, int lq, int lk, int hq, int hkv, int d, int64_t q_sb,         \
      int64_t q_sl, int64_t q_sh, int64_t k_sb, int64_t k_sl,              \
      int64_t k_sh, int64_t v_sb, int64_t v_sl, int64_t v_sh,              \
      int64_t do_sb, int64_t do_sl, int64_t do_sh, int causal, int window, \
      float soft_cap, float sm_scale, void *stream
#define BWD_ARGS                                                          \
  q, k, v, dout, lse, stats, out_a, out_b, b, lq, lk, hq, hkv, d, q_sb,  \
      q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, do_sb, do_sl,      \
      do_sh, causal, window, soft_cap, sm_scale

// dK into out_a and dV into out_b, (B, Lk, Hkv, D), from the stats that
// flash_attention_bwd_dq_f32 wrote
int flash_attention_bwd_dkdv_f32(BWD_PARAMS) {
  BwdArgs a;
  const int err = make_args(a, BWD_ARGS);
  if (err != 0 || out_b == nullptr) return (int)cudaErrorInvalidValue;
  if (d <= 64) return launch_dkdv<64, 64, 32>(a, b, stream);
  if (d <= 128) return launch_dkdv<128, 64, 32>(a, b, stream);
  return launch_dkdv<256, 32, 32>(a, b, stream);
}

// dQ into out_a, (B, Lq, Hq, D), and the rows' lse' and delta into
// stats; out_b is not read
int flash_attention_bwd_dq_f32(BWD_PARAMS) {
  BwdArgs a;
  const int err = make_args(a, BWD_ARGS);
  if (err != 0) return err;
  if (d <= 64) return launch_dq<64, 64, 32>(a, b, stream);
  if (d <= 128) return launch_dq<128, 64, 32>(a, b, stream);
  return launch_dq<256, 32, 32>(a, b, stream);
}

const char *flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
