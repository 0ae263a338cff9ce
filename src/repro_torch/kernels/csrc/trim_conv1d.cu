// Causal depthwise conv1d for NVIDIA Hopper (sm_90a), f32 and bf16,
// hand-written CUDA.
//
// Replaces the TPU Pallas kernel _kernel of
// src/repro/kernels/trim_conv1d.py:29 (wrapper trim_conv1d, :57): the
// temporal conv of the Mamba mixer (and of RG-LRU),
//   y[b, t, d] = sum_{i < K} x[b, t-K+1+i, d] * w[i, d],
// with zero left padding.  No bias and no activation: the mixer adds
// conv_b and applies SiLU outside, as in JAX.
//
// Rounding.  Each output is summed from 0 in the order i = 0..K-1, every
// product rounded before its add (__fmul_rn, __fadd_rn: nvcc may not
// contract them into an FMA).  That is the arithmetic of the plain
// versions (trim_conv1d_plain, ref.depthwise_conv1d: PyTorch's separate
// elementwise multiply and add kernels), so the kernel equals them bit
// for bit, and stepping the decode path (ref.depthwise_conv1d_step, the
// same order) through a sequence equals it too.  Only the geometry, the
// loads and the schedule below decide how fast it is; none of them
// touches an output's sum.
//
// What bounds it on the H100.  Bytes: 2 K FLOPs an output against one
// element read and one written.  At falcon-mamba-7b's prefill (B 2, L
// 2048, D 8192, K 4) x and y are 268 MB in f32, 0.080 ms at 3.35 TB/s,
// while the 268 MFLOP take 0.004 ms at 67 TFLOP/s; at recurrentgemma-2b's
// training row (1, 4096, 2560) in bf16 the whole call is 42 MB, 0.0125
// ms, so the launch and the last wave's tail count too.
//
// The design (core/conv_plan.py, Conv1dPlan).  The TPU kernel sweeps
// chunks of 512 steps in order on one core and carries the K-1 boundary
// rows in VMEM from one grid step to the next.  Blocks on the card run in
// parallel and in no order, so here:
// (1) A block is one warp (kLanes threads), and the warp owns one run of
// tile_l timesteps of one sequence over one channel warp: 32 lanes of kVec
// consecutive channels, one 16-byte load or store a row (4 f32 or 8 bf16
// channels) where D, the strides and the pointers allow it; elsewhere one
// channel a lane.  A warp's row is 512 contiguous bytes.  The channel
// warps tile D from its start, so only the last channel warp of a row can
// hold idle lanes, and none does where D is a multiple of 32 kVec (D 2560:
// 20 f32 or 10 bf16 warps).  Grid (runs x channel warps, B), run-major:
// the warps the scheduler holds at once cover whole rows of neighbouring
// runs.
// (2) A lane keeps its channels' K taps and the K-1 previous inputs (the
// shadow registers) in registers as it walks the run, so each input row
// is loaded once a run and shifts through the window; the run's first
// K-1 inputs are re-read (zeros before t = 0): the halo, rows the
// previous run's warp reads at about the same time, so mostly from L2.
// (3) Loads go in batches of kAhead = 8 rows, and the next batch is issued
// before the current one is summed: 16 rows, 256 bytes a lane and 8 KB a
// warp, in flight while a warp waits, without shared memory.
// (4) The plan takes the shortest run of 256..8 steps whose K-1 halo rows
// stay within a fifth of it: 16 steps at K = 4, so a warp issues its
// whole run in its first two batches, and the grid (2,560 to 16,384
// warps at the main-path rows, several waves of the 12-16 warps an SM
// holds) keeps every SM streaming, Little's law's 25.4 KB in flight an
// SM (3.35 TB/s x 1 us / 132) several times over, with a short tail.
// Longer runs (32 to 256 steps: fewer, longer-lived warps, down to one
// wave) read up to 1.4x slower in f32 and 2x in bf16 at the same rows
// (tools/conv1d_fwd_ablation.py, NVIDIA H100 80GB HBM3, 700 W): the
// re-read halo costs little, too few warps and their tail cost much.
// The earlier design ran 256-thread blocks of one channel a thread (4
// bytes a load in f32), runs of 8-32 steps for 3 waves, and at D 2560 in
// bf16 a second channel tile 75% idle.
//
// The input gradient runs this kernel too.  dx[t] = sum_i w[i] dy[t+K-1-i]
// is, in reversed time, the causal conv of the reversed cotangent with the
// same taps in the same order, so the wrapper passes dy and dx at row L-1
// with their time strides negated (no copy).  Every offset is an int64_t
// product of a signed index and a signed stride, so a negative time
// stride walks backwards from the base pointer; the 16-byte rows hold
// there too (the strides stay multiples of kVec).
//
// Any K >= 2.  The register window needs K at compile time, so K = 2..8
// are template instances (every registered config has K = 4).  A larger K
// runs trim_conv1d_any_k, the same geometry with K as an argument, which
// re-reads the K-1 previous inputs of each output through the L1 cache
// (__ldg) instead of shifting them through registers: each output still
// sums the same rounded products from 0 in tap order, so it equals the
// plain version bit for bit at every K.
//
// bf16 (trim_conv1d_bf16).  The TPU kernel widens each bf16 input and tap
// to f32, sums from 0 in tap order in f32 and casts once at the store
// (_kernel's acc and o_ref[0] = acc.astype, trim_conv1d.py:38-40).  Here
// the same template runs on bf16 operands: each value widens exactly
// (its 16 bits are the high half of the f32), a bf16 x bf16 product is
// exact in f32, so the f32 chain above is that function and the one
// rounding is __float2bfloat16_rn at the store; the kernel equals its
// plain version and the TPU kernel bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;     // threads a block, one warp: CONV1D_LANES
constexpr int kVecF32 = 4;     // f32 channels a lane, 16-byte rows
constexpr int kVecBf16 = 8;    // bf16 channels a lane, 16-byte rows
constexpr int kAhead = 8;      // rows of a load batch: CONV1D_AHEAD
constexpr int kMinBlocks = 12;     // warps an SM: CONV1D_RESIDENT_WARPS
constexpr int kMaxUnrolledK = 8;   // CONV1D_UNROLLED_K

template <typename T>
struct Conv1dArgs {
  const T *x, *w;
  T *y;
  int length, d, tile_l, d_warps;
  // strides in elements; x_sl and y_sl are < 0 for the input gradient
  int64_t x_sb, x_sl, y_sb, y_sl;
};

// One row of a lane's V channels: the raw bits a load brings (Raw), their
// f32 values (widen, exact) and the one rounding to T at the store.
template <typename T, int V>
struct Row;
template <>
struct Row<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float *p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void widen(Raw r, float (&v)[1]) {
    v[0] = r;
  }
  static __device__ __forceinline__ void store(float *p,
                                               const float (&v)[1]) {
    *p = v[0];
  }
};
template <>
struct Row<float, kVecF32> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float *p) {
    return __ldg(reinterpret_cast<const float4 *>(p));
  }
  static __device__ __forceinline__ void widen(Raw r, float (&v)[4]) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  static __device__ __forceinline__ void store(float *p,
                                               const float (&v)[4]) {
    *reinterpret_cast<float4 *>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Row<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16 *p) {
    return __ldg(reinterpret_cast<const unsigned short *>(p));
  }
  static __device__ __forceinline__ void widen(Raw r, float (&v)[1]) {
    v[0] = __uint_as_float((uint32_t)r << 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16 *p,
                                               const float (&v)[1]) {
    *p = __float2bfloat16_rn(v[0]);
  }
};
template <>
struct Row<__nv_bfloat16, kVecBf16> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16 *p) {
    return __ldg(reinterpret_cast<const uint4 *>(p));
  }
  // element 2i is the low half of word i
  static __device__ __forceinline__ void widen(Raw r, float (&v)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16 *p,
                                               const float (&v)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(
                  __float2bfloat16_rn(v[2 * i + 1]))
              << 16);
    *reinterpret_cast<uint4 *>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// The warp's run and the lane's first channel, or false for a lane past D
// (only in a row's last channel warp).
template <typename T, int V>
__device__ __forceinline__ bool lane_of(const Conv1dArgs<T> &a, int &c,
                                        int &t0, int &t1) {
  const int run = blockIdx.x / a.d_warps;
  c = (blockIdx.x - run * a.d_warps) * (kLanes * V) + threadIdx.x * V;
  t0 = run * a.tile_l;
  t1 = min(t0 + a.tile_l, a.length);
  return c < a.d;
}

// Rows tb .. tb + kAhead - 1 of the lane's channels; zeros past the run.
template <typename R, typename T>
__device__ __forceinline__ void load_batch(const T *xc, int64_t sl, int tb,
                                           int t1,
                                           typename R::Raw (&r)[kAhead]) {
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    r[u] = typename R::Raw{};
    if (tb + u < t1) r[u] = R::load(xc + (int64_t)(tb + u) * sl);
  }
}

template <typename T, int K, int V>
__global__ void __launch_bounds__(kLanes, kMinBlocks)
    trim_conv1d_kernel(const Conv1dArgs<T> a) {
  using R = Row<T, V>;
  int c, t0, t1;
  if (!lane_of<T, V>(a, c, t0, t1)) return;
  const T *__restrict__ xc = a.x + (int64_t)blockIdx.y * a.x_sb + c;
  T *__restrict__ yc = a.y + (int64_t)blockIdx.y * a.y_sb + c;

  // the run's first batch goes out before the taps and the halo
  typename R::Raw cur[kAhead];
  load_batch<R>(xc, a.x_sl, t0, t1, cur);
  float wr[K][V];
#pragma unroll
  for (int i = 0; i < K; ++i) R::widen(R::load(a.w + (int64_t)i * a.d + c),
                                       wr[i]);
  // the shadow registers: the K-1 inputs before the run
  float win[K][V];
#pragma unroll
  for (int i = 0; i < K - 1; ++i) {
    const int t = t0 - (K - 1) + i;
    typename R::Raw raw{};
    if (t >= 0) raw = R::load(xc + (int64_t)t * a.x_sl);
    R::widen(raw, win[i]);
  }
  for (int tb = t0; tb < t1; tb += kAhead) {
    // the next batch is in flight while this one is summed
    typename R::Raw nxt[kAhead];
    load_batch<R>(xc, a.x_sl, tb + kAhead, t1, nxt);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      R::widen(cur[u], win[K - 1]);
      float acc[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc[j] = 0.0f;
#pragma unroll
        for (int i = 0; i < K; ++i)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(win[i][j], wr[i][j]));
      }
      if (tb + u < t1) R::store(yc + (int64_t)(tb + u) * a.y_sl, acc);
#pragma unroll
      for (int i = 0; i < K - 1; ++i)
#pragma unroll
        for (int j = 0; j < V; ++j) win[i][j] = win[i + 1][j];
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) cur[u] = nxt[u];
  }
}

// K as an argument, the same geometry: the previous inputs are re-read
// through L1 (the warp read the same rows for the outputs before), the
// taps likewise; zeros before t = 0.
template <typename T, int V>
__global__ void __launch_bounds__(kLanes, kMinBlocks)
    trim_conv1d_any_k(const Conv1dArgs<T> a, const int k) {
  using R = Row<T, V>;
  int c, t0, t1;
  if (!lane_of<T, V>(a, c, t0, t1)) return;
  const T *__restrict__ xc = a.x + (int64_t)blockIdx.y * a.x_sb + c;
  T *__restrict__ yc = a.y + (int64_t)blockIdx.y * a.y_sb + c;
  for (int t = t0; t < t1; ++t) {
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
    for (int i = 0; i < k; ++i) {
      const int tt = t - (k - 1) + i;
      typename R::Raw raw{};
      if (tt >= 0) raw = R::load(xc + (int64_t)tt * a.x_sl);
      float xv[V], wv[V];
      R::widen(raw, xv);
      R::widen(R::load(a.w + (int64_t)i * a.d + c), wv);
#pragma unroll
      for (int j = 0; j < V; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(xv[j], wv[j]));
    }
    R::store(yc + (int64_t)t * a.y_sl, acc);
  }
}

template <typename T, int V>
int launch_k(const Conv1dArgs<T> &a, int k, dim3 grid, void *stream) {
  static_assert(kMaxUnrolledK == 8, "the switch below instances K 2..8");
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 2: trim_conv1d_kernel<T, 2, V><<<grid, kLanes, 0, s>>>(a); break;
    case 3: trim_conv1d_kernel<T, 3, V><<<grid, kLanes, 0, s>>>(a); break;
    case 4: trim_conv1d_kernel<T, 4, V><<<grid, kLanes, 0, s>>>(a); break;
    case 5: trim_conv1d_kernel<T, 5, V><<<grid, kLanes, 0, s>>>(a); break;
    case 6: trim_conv1d_kernel<T, 6, V><<<grid, kLanes, 0, s>>>(a); break;
    case 7: trim_conv1d_kernel<T, 7, V><<<grid, kLanes, 0, s>>>(a); break;
    case 8: trim_conv1d_kernel<T, 8, V><<<grid, kLanes, 0, s>>>(a); break;
    default: trim_conv1d_any_k<T, V><<<grid, kLanes, 0, s>>>(a, k);
  }
  return (int)cudaGetLastError();
}

// Checks the geometry and launches: a warp a block, tile_d = 32 vec
// channels a warp.  cudaErrorInvalidValue for what the kernel cannot take
// or a geometry the plan would not give.
template <typename T>
int run(const T *x, const T *w, T *y, int b, int length, int d, int k,
        int64_t x_sb, int64_t x_sl, int64_t y_sb, int64_t y_sl, int tile_l,
        int tile_d, int vec, void *stream) {
  constexpr int kVec = sizeof(T) == 4 ? kVecF32 : kVecBf16;
  if ((vec != 1 && vec != kVec) || tile_d != kLanes * vec)
    return (int)cudaErrorInvalidValue;
  if (b < 1 || b > 65535 || length < 1 || d < 1 || k < 2 || tile_l < 1)
    return (int)cudaErrorInvalidValue;
  // 16-byte rows: D, the strides and the pointers in whole vectors
  const auto al16 = [](const void *p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (vec != 1 && (d % vec || x_sb % vec || x_sl % vec || y_sb % vec ||
                   y_sl % vec || !al16(x) || !al16(w) || !al16(y)))
    return (int)cudaErrorInvalidValue;
  const int64_t runs = ((int64_t)length + tile_l - 1) / tile_l;
  const int64_t d_warps = ((int64_t)d + tile_d - 1) / tile_d;
  if (runs * d_warps > 2147483647) return (int)cudaErrorInvalidValue;
  Conv1dArgs<T> a;
  a.x = x; a.w = w; a.y = y;
  a.length = length; a.d = d; a.tile_l = tile_l; a.d_warps = (int)d_warps;
  a.x_sb = x_sb; a.x_sl = x_sl; a.y_sb = y_sb; a.y_sl = y_sl;
  const dim3 grid((unsigned)(runs * d_warps), (unsigned)b);
  return vec == 1 ? launch_k<T, 1>(a, k, grid, stream)
                  : launch_k<T, kVec>(a, k, grid, stream);
}

}  // namespace

// C entry points, bound with ctypes by repro_torch/kernels/build.py.  They
// launch on `stream` without synchronising and return cudaGetLastError()
// (or cudaErrorInvalidValue for a geometry the kernel cannot take).
// x: (B, L, D) with channel stride 1 and strides x_sb, x_sl; w: (K, D)
// contiguous; y: (B, L, D) with strides y_sb, y_sl (the time strides of
// either may be negative, the pointers then at row L-1); tile_l: steps a
// run; tile_d: channels a warp, 32 vec; vec: channels a lane, 1 or 4 (f32)
// / 8 (bf16) where rows are 16-byte aligned (checked here).
extern "C" {

int trim_conv1d_f32(const float *x, const float *w, float *y, int b,
                    int length, int d, int k, int64_t x_sb, int64_t x_sl,
                    int64_t y_sb, int64_t y_sl, int tile_l, int tile_d,
                    int vec, void *stream) {
  return run<float>(x, w, y, b, length, d, k, x_sb, x_sl, y_sb, y_sl,
                    tile_l, tile_d, vec, stream);
}

// bf16 x, w and y, f32 sums (see "bf16" above)
int trim_conv1d_bf16(const __nv_bfloat16 *x, const __nv_bfloat16 *w,
                     __nv_bfloat16 *y, int b, int length, int d, int k,
                     int64_t x_sb, int64_t x_sl, int64_t y_sb, int64_t y_sl,
                     int tile_l, int tile_d, int vec, void *stream) {
  return run<__nv_bfloat16>(x, w, y, b, length, d, k, x_sb, x_sl, y_sb,
                            y_sl, tile_l, tile_d, vec, stream);
}

const char *trim_conv1d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
