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
// same order) through a sequence equals it too.
//
// Geometry (core/conv_plan.py, Conv1dPlan).  The TPU kernel sweeps chunks
// of 512 steps in order on one core and carries the K-1 boundary rows in
// VMEM from one grid step to the next.  Blocks on the card run in parallel
// and in no order, so here a thread owns one channel of one run of tile_l
// timesteps and keeps the K-1 previous inputs of its channel in registers
// -- the shadow registers -- as it walks the run: each input row is loaded
// once per run and shifts through the window.  A run's first K-1 inputs
// are re-read from device memory (zeros before t = 0): the halo, 3 rows in
// 32 at the full-width shape, and mostly L2 hits since the neighbouring
// run has just read them.  A block is tile_d consecutive channels, one a
// thread, so a warp's loads and stores of a row are 128 contiguous bytes.
// Grid (runs, channel tiles, B).  The input is read through its batch and
// time strides (the channel stride is 1): the mixer's x is the first half
// of the in-projection, a view whose row stride is 2 * d_inner, and it is
// read in place, with no contiguous copy.
//
// What bounds it on the H100.  Bytes: 2 K FLOPs per output against 8 bytes
// of x and y.  At the mamba prefill's shape (B = 2, L = 2048, D = 8192,
// K = 4) x and y are 268 MB, 0.080 ms at 3.35 TB/s; the 268 MFLOP take
// 0.004 ms at 67 TFLOP/s.  The kernel keeps kUnroll = 8 loads in flight a
// thread (2048 threads an SM, 64 KB in flight an SM) to cover the memory
// latency; it does nothing else for speed.
//
// The input gradient runs this kernel too.  dx[t] = sum_i w[i] dy[t+K-1-i]
// is, in reversed time, the causal conv of the reversed cotangent with the
// same taps in the same order, so the wrapper passes dy and dx at row L-1
// with their time strides negated (no copy).  Every offset is an int64_t
// product of a signed index and a signed stride, so a negative time
// stride walks backwards from the base pointer.
//
// Any K >= 2.  The register window needs K at compile time, so K = 2..8
// are template instances (every registered config has K = 4).  A larger K
// runs trim_conv1d_any_k, which takes K as an argument and re-reads the
// K-1 previous inputs of each output through the L1 cache (__ldg) instead
// of shifting them through registers: each output still sums the same
// rounded products from 0 in tap order, so it equals the plain version
// bit for bit at every K.
//
// bf16 (trim_conv1d_bf16).  The TPU kernel widens each bf16 input and tap
// to f32, sums from 0 in tap order in f32 and casts once at the store
// (_kernel's acc and o_ref[0] = acc.astype, trim_conv1d.py:38-40).  Here
// the same template runs on bf16 operands: each value widens exactly
// (its 16 bits are the high half of the f32), a bf16 x bf16 product is
// exact in f32, so the f32 chain above is that function and the one
// rounding is __float2bfloat16_rn at the store; the kernel equals its
// plain version and the TPU kernel bit for bit.  Where rows are 16-byte
// aligned (D, the strides and the pointers multiples of 8 elements), a
// thread owns kVec = 8 consecutive channels and moves each row's 8
// values with one 16-byte load or store (half the f32 route's bytes a
// row, a quarter of its loads); elsewhere one channel, as in f32.  A
// thread then keeps 8 x K taps and 8 x K window registers, so it loads
// kUnroll / 2 rows ahead.  What bounds it is the same: bytes, half the
// f32 count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 8;     // timesteps loaded ahead by each thread
constexpr int kMaxThreads = 256;  // threads a block: CONV1D_TILE_D
constexpr int kVec = 8;        // bf16 channels a thread, one 16-byte row
                               // load (CONV1D_BF16_VEC of conv_plan.py)

template <typename T>
struct Conv1dArgs {
  const T *x, *w;
  T *y;
  int length, d, tile_l;
  // strides in elements; x_sl and y_sl are < 0 for the input gradient
  int64_t x_sb, x_sl, y_sb, y_sl;
};

// V consecutive elements of a row, widened to f32 (exact)
__device__ __forceinline__ void load_row(const float *p, float (&v)[1]) {
  v[0] = __ldg(p);
}
__device__ __forceinline__ void load_row(const __nv_bfloat16 *p,
                                         float (&v)[1]) {
  v[0] = __uint_as_float(
      (uint32_t)__ldg(reinterpret_cast<const unsigned short *>(p)) << 16);
}
__device__ __forceinline__ void load_row(const __nv_bfloat16 *p,
                                         float (&v)[kVec]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4 *>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  // element 2i is the low half of word i
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// the one rounding to the output type
__device__ __forceinline__ void store_row(float *p, const float (&v)[1]) {
  *p = v[0];
}
__device__ __forceinline__ void store_row(__nv_bfloat16 *p,
                                          const float (&v)[1]) {
  *p = __float2bfloat16_rn(v[0]);
}
__device__ __forceinline__ void store_row(__nv_bfloat16 *p,
                                          const float (&v)[kVec]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]))
            << 16);
  *reinterpret_cast<uint4 *>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <int V>
__device__ __forceinline__ void zero_row(float (&v)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = 0.0f;
}

// A thread: channels c .. c + V - 1 of one run (V = 1, or kVec for bf16
// rows read 16 bytes at a time).
template <typename T, int K, int V>
__global__ void __launch_bounds__(kMaxThreads)
    trim_conv1d_kernel(const Conv1dArgs<T> a) {
  constexpr int kAhead = V == 1 ? kUnroll : kUnroll / 2;
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (c >= a.d) return;
  const int t0 = blockIdx.x * a.tile_l;
  const int t1 = min(t0 + a.tile_l, a.length);
  const T *__restrict__ xc = a.x + (int64_t)blockIdx.z * a.x_sb + c;
  T *__restrict__ yc = a.y + (int64_t)blockIdx.z * a.y_sb + c;

  float wr[K][V];
#pragma unroll
  for (int i = 0; i < K; ++i) load_row(a.w + (int64_t)i * a.d + c, wr[i]);
  // the shadow registers: the K-1 inputs before the run
  float win[K][V];
#pragma unroll
  for (int i = 0; i < K - 1; ++i) {
    const int t = t0 - (K - 1) + i;
    if (t >= 0)
      load_row(xc + (int64_t)t * a.x_sl, win[i]);
    else
      zero_row(win[i]);
  }
  for (int tb = t0; tb < t1; tb += kAhead) {
    float in[kAhead][V];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (tb + u < t1)
        load_row(xc + (int64_t)(tb + u) * a.x_sl, in[u]);
      else
        zero_row(in[u]);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      float acc[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        win[K - 1][j] = in[u][j];
        acc[j] = 0.0f;
#pragma unroll
        for (int i = 0; i < K; ++i)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(win[i][j], wr[i][j]));
      }
      if (tb + u < t1) store_row(yc + (int64_t)(tb + u) * a.y_sl, acc);
#pragma unroll
      for (int i = 0; i < K - 1; ++i)
#pragma unroll
        for (int j = 0; j < V; ++j) win[i][j] = win[i + 1][j];
    }
  }
}

// K as an argument: the previous inputs are re-read through L1 (the
// neighbouring threads of a warp read the neighbouring channels of the
// same rows), the weights likewise; zeros before t = 0.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
    trim_conv1d_any_k(const Conv1dArgs<T> a, const int k) {
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (c >= a.d) return;
  const int t0 = blockIdx.x * a.tile_l;
  const int t1 = min(t0 + a.tile_l, a.length);
  const T *__restrict__ xc = a.x + (int64_t)blockIdx.z * a.x_sb + c;
  T *__restrict__ yc = a.y + (int64_t)blockIdx.z * a.y_sb + c;
  for (int t = t0; t < t1; ++t) {
    float acc[V];
    zero_row(acc);
    for (int i = 0; i < k; ++i) {
      const int tt = t - (k - 1) + i;
      float xv[V], wv[V];
      if (tt >= 0)
        load_row(xc + (int64_t)tt * a.x_sl, xv);
      else
        zero_row(xv);
      load_row(a.w + (int64_t)i * a.d + c, wv);
#pragma unroll
      for (int j = 0; j < V; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(xv[j], wv[j]));
    }
    store_row(yc + (int64_t)t * a.y_sl, acc);
  }
}

template <typename T, int V>
int launch_k(const Conv1dArgs<T> &a, int k, dim3 grid, int threads,
             void *stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 2: trim_conv1d_kernel<T, 2, V><<<grid, threads, 0, s>>>(a); break;
    case 3: trim_conv1d_kernel<T, 3, V><<<grid, threads, 0, s>>>(a); break;
    case 4: trim_conv1d_kernel<T, 4, V><<<grid, threads, 0, s>>>(a); break;
    case 5: trim_conv1d_kernel<T, 5, V><<<grid, threads, 0, s>>>(a); break;
    case 6: trim_conv1d_kernel<T, 6, V><<<grid, threads, 0, s>>>(a); break;
    case 7: trim_conv1d_kernel<T, 7, V><<<grid, threads, 0, s>>>(a); break;
    case 8: trim_conv1d_kernel<T, 8, V><<<grid, threads, 0, s>>>(a); break;
    default: trim_conv1d_any_k<T, V><<<grid, threads, 0, s>>>(a, k);
  }
  return (int)cudaGetLastError();
}

// Checks the geometry and launches: tile_d channels a block, vec a
// thread.  cudaErrorInvalidValue for what the kernel cannot take.
template <typename T>
int run(const T *x, const T *w, T *y, int b, int length, int d, int k,
        int64_t x_sb, int64_t x_sl, int64_t y_sb, int64_t y_sl, int tile_l,
        int tile_d, int vec, void *stream) {
  if (vec < 1 || tile_d % vec != 0) return (int)cudaErrorInvalidValue;
  const int threads = tile_d / vec;
  if (b < 1 || b > 65535 || length < 1 || d < 1 || k < 2 ||
      tile_l < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t runs = ((int64_t)length + tile_l - 1) / tile_l;
  const int64_t d_tiles = ((int64_t)d + tile_d - 1) / tile_d;
  if (runs > 2147483647 || d_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  Conv1dArgs<T> a;
  a.x = x; a.w = w; a.y = y;
  a.length = length; a.d = d; a.tile_l = tile_l;
  a.x_sb = x_sb; a.x_sl = x_sl; a.y_sb = y_sb; a.y_sl = y_sl;
  const dim3 grid((unsigned)runs, (unsigned)d_tiles, (unsigned)b);
  if (vec == 1) return launch_k<T, 1>(a, k, grid, threads, stream);
  if constexpr (sizeof(T) == 2) {
    // 16-byte rows: D, the strides and the pointers in whole vectors
    const auto al = [](const void *p) {
      return reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    if (vec == kVec && d % kVec == 0 && x_sb % kVec == 0 &&
        x_sl % kVec == 0 && y_sb % kVec == 0 && y_sl % kVec == 0 &&
        al(x) && al(w) && al(y))
      return launch_k<T, kVec>(a, k, grid, threads, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry point, bound with ctypes by repro_torch/kernels/build.py.  It
// launches on `stream` without synchronising and returns cudaGetLastError()
// (or cudaErrorInvalidValue for a geometry the kernel cannot take).
// x: (B, L, D) with channel stride 1 and strides x_sb, x_sl; w: (K, D)
// contiguous; y: (B, L, D) with strides y_sb, y_sl (the time strides of
// either may be negative, the pointers then at row L-1).
extern "C" {

int trim_conv1d_f32(const float *x, const float *w, float *y, int b,
                    int length, int d, int k, int64_t x_sb, int64_t x_sl,
                    int64_t y_sb, int64_t y_sl, int tile_l, int tile_d,
                    void *stream) {
  return run<float>(x, w, y, b, length, d, k, x_sb, x_sl, y_sb, y_sl,
                    tile_l, tile_d, 1, stream);
}

// bf16 x, w and y, f32 sums (see "bf16" above); vec is 1 or 8 channels
// a thread (8: rows 16-byte aligned, checked here).
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
