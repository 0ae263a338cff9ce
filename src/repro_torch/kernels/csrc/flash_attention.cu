// Flash attention for NVIDIA Hopper (sm_90a), f32, hand-written CUDA.
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
// Geometry.  A block owns (batch b, KV head, tile of kRows = 64 query rows)
// where a row is one (query position, head of the GQA group) pair, taken
// position-major: row t is position t / G of head g = t % G, G = Hq / Hkv.
// All G query heads that read one KV head share the block, so each K/V
// tile is read from device memory once per block and serves 64 rows: the
// fetch-once contract of the TPU kernel's BlockSpecs.  Any G works (10 for
// recurrentgemma, 7 for llava) without padding heads.  The loop over key
// tiles inside the block takes the place of the TPU's sequential ik grid
// axis.  The head dim is zero-padded in shared memory to Dp = 64, 128 or
// 256 (a template parameter), so D = 12, 14, 16 (SMOKE configs), 128 and
// 256 all run; stores are masked to d < D, and ragged Lq / Lk edges are
// masked at the load (zeros) and in s (-1e30).  q, k, v and o are read and
// written in the JAX (B, L, H, D) layout through their strides (the head
// dim contiguous): no transposed or padded copy is made.
//
// Wide heads.  D > 256 runs flash_attention_wide_kernel: whole-D tiles
// would not fit 227 KB (Q, K and V of 64 rows at D = 320 take 252 KB), so
// there S = Q K^T walks D in chunks of kWideDs = 64 columns (Q and K chunks
// staged in turn, the scores' fmaf chains continued across chunks in
// ascending d, as the narrow kernel sums them), and a block accumulates
// kWideDo = 256 output columns: the grid gets ceil(D / 256) blocks per
// (row tile, KV head, batch), each recomputing the same scores and
// softmax (bitwise the same in every block) for its slice of P V.
// Shared memory is 119 KB whatever D is, so every D runs; the scores are
// computed ceil(D / 256) times (2x at D = 320 and 512).
//
// Threads.  256 threads as 16 x 16: thread (ty, tx) owns rows ty + 16 i
// (i < 4), score columns tx + 16 j (j < 4) of the 64 x 64 tile, and output
// columns 4 tx + 64 c + (0..3) (c < Dp / 64).  S = Q K^T reads float4s of Q
// and K rows from shared memory (row stride Dp + 4: conflict-free for
// columns tx + 16 j) and issues 64 FMAs per 8 LDS.128; row maxima and sums
// reduce over the 16 lanes of a half-warp with shuffles; P goes through
// shared memory (into the K buffer, free by then) for O += P V, which reads
// float4 rows of V.  Shared memory: Q, K (then P) and V tiles, (3 * 64) x
// (Dp + 4) floats: 52 KB, 101 KB and 200 KB for Dp = 64, 128, 256.
//
// What bounds it on the H100.  Operations: f32 FMAs outside the tensor
// cores, 67 TFLOP/s.  At the slice's shape (B = 2, L = 4096, Hq = 16,
// Hkv = 2, D = 128, causal) a layer needs 4 D FLOPs a valid (query, key)
// pair, 137 GFLOP, i.e. 2.05 ms at the peak, against 67 MB of Q, K, V and
// O (0.02 ms at 3.35 TB/s).  This first kernel keeps the work on the
// non-tensor f32 pipes with one 4 x 4 register tile of scores and a
// 4 x 4 (Dp / 64) accumulator tile a thread, loads each K/V tile with all
// threads and then computes (no copy/compute overlap), and fits two blocks
// (16 warps) a SM at Dp = 128.  A later PR would move both products to the
// tensor cores (TF32 or bf16 wgmma, 495 / 989 TFLOP/s), stage K/V with TMA
// in a ring of tiles behind a producer warp, and split long key ranges of
// few-row calls (Lq = 17) over blocks.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kRows = 64;       // (query position, head) rows per block
constexpr int kKeys = 64;       // keys per tile
constexpr int kMaxNarrowDp = 256;   // larger D: the wide kernel
constexpr int kWideDs = 64;         // D columns of Q and K a chunk (wide)
constexpr int kWideDo = 256;        // output columns a block (wide)
constexpr float kNegInf = -1e30f;   // the TPU kernel's mask value
constexpr int kMaxSmemBytes = 232448;  // H100: 227 KB opt-in per block

struct AttnArgs {
  const float *q, *k, *v;
  float *o;
  int lq, lk, hq, hkv, d, group;
  int64_t q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh;
  int64_t o_sb, o_sl, o_sh;
  int causal, window;   // window <= 0: none
  float soft_cap;       // <= 0: none
  float sm_scale;
  int row_tiles;
};

template <int kDp>
constexpr size_t smem_bytes() {
  return (size_t)3 * kRows * (kDp + 4) * sizeof(float);
}

// Loads rows [row0, row0 + kKeys) of one KV head into a (kKeys, kDp + 4)
// tile, zeros past lk and past d.
template <int kDp>
__device__ __forceinline__ void load_kv_tile(float *dst, const float *src,
                                             int64_t sb, int64_t sl,
                                             int64_t sh, int b, int head,
                                             int row0, int lk, int d) {
  const float *base = src + (int64_t)b * sb + (int64_t)head * sh;
#pragma unroll 4
  for (int e = threadIdx.x; e < kKeys * kDp; e += kThreads) {
    const int r = e / kDp, dd = e % kDp;
    const int key = row0 + r;
    float val = 0.f;
    if (key < lk && dd < d) val = __ldg(base + (int64_t)key * sl + dd);
    dst[r * (kDp + 4) + dd] = val;
  }
}

template <int kDp>
__global__ void __launch_bounds__(kThreads, kDp <= 128 ? 2 : 1)
    flash_attention_kernel(const AttnArgs a) {
  constexpr int kStride = kDp + 4;     // Q / K / V row stride (floats)
  constexpr int kPStride = kKeys + 4;  // P row stride
  constexpr int kDc = kDp / 64;        // float4 output columns a thread
  extern __shared__ float4 smem4[];
  float *qs = reinterpret_cast<float *>(smem4);
  float *ks = qs + kRows * kStride;    // K tile, then P
  float *vs = ks + kKeys * kStride;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  // the last row tiles, the longest under a causal mask, start first
  const int tile = a.row_tiles - 1 - (int)blockIdx.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int g = a.group, n_rows = a.lq * g;
  const int t0 = tile * kRows;
  const int off = a.lk - a.lq;         // right-aligned queries

  // Q tile: row r is (position (t0 + r) / G, head kvh * G + (t0 + r) % G)
  for (int e = tid; e < kRows * kDp; e += kThreads) {
    const int r = e / kDp, dd = e % kDp, t = t0 + r;
    float val = 0.f;
    if (t < n_rows && dd < a.d) {
      const int qi = t / g, h = kvh * g + t % g;
      val = __ldg(a.q + (int64_t)b * a.q_sb + (int64_t)qi * a.q_sl +
                  (int64_t)h * a.q_sh + dd);
    }
    qs[r * kStride + dd] = val;
  }

  int q_pos[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    row_ok[i] = t < n_rows;
    q_pos[i] = t / g + off;
  }
  // key range of the block's rows (positions t0 / G .. last / G)
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

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();   // the previous tile's P and V are consumed
    load_kv_tile<kDp>(ks, a.k, a.k_sb, a.k_sl, a.k_sh, b, kvh, k0, a.lk, a.d);
    load_kv_tile<kDp>(vs, a.v, a.v_sb, a.v_sl, a.v_sh, b, kvh, k0, a.lk, a.d);
    __syncthreads();

    // S = Q K^T: one fmaf chain over d a score
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 1
    for (int dd = 0; dd < kDp; dd += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4 *>(
            &qs[(ty + 16 * i) * kStride + dd]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4 *>(
            &ks[(tx + 16 * j) * kStride + dd]);
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

    __syncthreads();   // every thread is done reading the K tile
    float *ps = ks;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = s[i][j];
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
              &vs[(c0 + cc) * kStride + 4 * tx + 64 * c]);
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

  // o = acc / max(l, 1e-30), stored for d < D
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= n_rows) continue;
    const int qi = t / g, h = kvh * g + t % g;
    float *dst = a.o + (int64_t)b * a.o_sb + (int64_t)qi * a.o_sl +
                 (int64_t)h * a.o_sh;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kDc; ++c) {
      const int d0 = 4 * tx + 64 * c;
      const float vals[4] = {acc[i][c].x, acc[i][c].y, acc[i][c].z,
                             acc[i][c].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d0 + e < a.d) dst[d0 + e] = vals[e] / den;
    }
  }
}

template <int kDp>
int launch(const AttnArgs &a, int b, void *stream) {
  constexpr size_t smem = smem_bytes<kDp>();
  static_assert(smem <= (size_t)kMaxSmemBytes, "tile exceeds shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<kDp>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.row_tiles, a.hkv, b);
  flash_attention_kernel<kDp><<<grid, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}


// D > 256: S over D chunks of kWideDs, P V over kWideDo output columns a
// block (see "Wide heads" above).  The rows, the mask, the tile skip and
// the online softmax are the narrow kernel's.
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_wide_kernel(const AttnArgs a) {
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
  const float *kbase = a.k + (int64_t)b * a.k_sb + (int64_t)kvh * a.k_sh;
  const float *vbase = a.v + (int64_t)b * a.v_sb + (int64_t)kvh * a.v_sh;

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
          qv = __ldg(a.q + (int64_t)b * a.q_sb + (int64_t)qi * a.q_sl +
                     (int64_t)h * a.q_sh + d0 + dd);
        }
        if (k0 + r < a.lk && d0 + dd < a.d)
          kv = __ldg(kbase + (int64_t)(k0 + r) * a.k_sl + d0 + dd);
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
        val = __ldg(vbase + (int64_t)(k0 + r) * a.v_sl + dv0 + dd);
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
    float *dst = a.o + (int64_t)b * a.o_sb + (int64_t)qi * a.o_sl +
                 (int64_t)h * a.o_sh;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kDc; ++c) {
      const int d0 = dv0 + 4 * tx + 64 * c;
      const float vals[4] = {acc[i][c].x, acc[i][c].y, acc[i][c].z,
                             acc[i][c].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d0 + e < a.d) dst[d0 + e] = vals[e] / den;
    }
  }
}

int launch_wide(const AttnArgs &a, int b, void *stream) {
  constexpr size_t smem =
      ((size_t)(kRows + kKeys) * (kWideDs + 4) + (size_t)kRows * (kKeys + 4) +
       (size_t)kKeys * (kWideDo + 4)) * sizeof(float);
  static_assert(smem <= (size_t)kMaxSmemBytes, "tile exceeds shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wide_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)a.row_tiles * ((a.d + kWideDo - 1) / kWideDo);
  if (blocks > 2147483647) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, a.hkv, b);
  flash_attention_wide_kernel<<<grid, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes by repro_torch/kernels/build.py.  It
// launches on `stream` without synchronising and returns cudaGetLastError()
// (or cudaErrorInvalidValue for a geometry the kernel cannot take).
// Strides are in elements; the head dim must be contiguous.
extern "C" {

int flash_attention_f32(const float *q, const float *k, const float *v,
                        float *o, int b, int lq, int lk, int hq, int hkv,
                        int d, int64_t q_sb, int64_t q_sl, int64_t q_sh,
                        int64_t k_sb, int64_t k_sl, int64_t k_sh,
                        int64_t v_sb, int64_t v_sl, int64_t v_sh,
                        int64_t o_sb, int64_t o_sl, int64_t o_sh, int causal,
                        int window, float soft_cap, float sm_scale,
                        void *stream) {
  if (b < 1 || lq < 1 || lk < 1 || hkv < 1 || hq < hkv || hq % hkv != 0 ||
      d < 1 || (causal && lq > lk) || b > 65535 ||
      hkv > 65535)
    return (int)cudaErrorInvalidValue;
  AttnArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
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
  a.row_tiles = (int)((rows + kRows - 1) / kRows);
  if (d <= 64) return launch<64>(a, b, stream);
  if (d <= 128) return launch<128>(a, b, stream);
  if (d <= kMaxNarrowDp) return launch<256>(a, b, stream);
  return launch_wide(a, b, stream);
}

const char *flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
