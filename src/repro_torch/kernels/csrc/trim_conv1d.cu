// Causal depthwise conv1d for NVIDIA Hopper (sm_90a), f32, hand-written CUDA.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 8;     // timesteps loaded ahead by each thread
constexpr int kMaxThreads = 256;  // tile_d: CONV1D_TILE_D of conv_plan.py

struct Conv1dArgs {
  const float *x, *w;
  float *y;
  int length, d, tile_l;
  // strides in elements; x_sl and y_sl are < 0 for the input gradient
  int64_t x_sb, x_sl, y_sb, y_sl;
};

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
    trim_conv1d_kernel(const Conv1dArgs a) {
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= a.d) return;
  const int t0 = blockIdx.x * a.tile_l;
  const int t1 = min(t0 + a.tile_l, a.length);
  const float *__restrict__ xc = a.x + (int64_t)blockIdx.z * a.x_sb + c;
  float *__restrict__ yc = a.y + (int64_t)blockIdx.z * a.y_sb + c;

  float wr[K];
#pragma unroll
  for (int i = 0; i < K; ++i) wr[i] = __ldg(a.w + (int64_t)i * a.d + c);
  // the shadow registers: the K-1 inputs before the run
  float win[K];
#pragma unroll
  for (int i = 0; i < K - 1; ++i) {
    const int t = t0 - (K - 1) + i;
    win[i] = t >= 0 ? __ldg(xc + (int64_t)t * a.x_sl) : 0.0f;
  }
  for (int tb = t0; tb < t1; tb += kUnroll) {
    float in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      in[u] = tb + u < t1 ? __ldg(xc + (int64_t)(tb + u) * a.x_sl) : 0.0f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      win[K - 1] = in[u];
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < K; ++i)
        acc = __fadd_rn(acc, __fmul_rn(win[i], wr[i]));
      if (tb + u < t1) yc[(int64_t)(tb + u) * a.y_sl] = acc;
#pragma unroll
      for (int i = 0; i < K - 1; ++i) win[i] = win[i + 1];
    }
  }
}

// K as an argument: the previous inputs are re-read through L1 (the
// neighbouring threads of a warp read the neighbouring channels of the
// same rows), the weights likewise; zeros before t = 0.
__global__ void __launch_bounds__(kMaxThreads)
    trim_conv1d_any_k(const Conv1dArgs a, const int k) {
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= a.d) return;
  const int t0 = blockIdx.x * a.tile_l;
  const int t1 = min(t0 + a.tile_l, a.length);
  const float *__restrict__ xc = a.x + (int64_t)blockIdx.z * a.x_sb + c;
  float *__restrict__ yc = a.y + (int64_t)blockIdx.z * a.y_sb + c;
  for (int t = t0; t < t1; ++t) {
    float acc = 0.0f;
    for (int i = 0; i < k; ++i) {
      const int tt = t - (k - 1) + i;
      const float xv = tt >= 0 ? __ldg(xc + (int64_t)tt * a.x_sl) : 0.0f;
      acc = __fadd_rn(acc, __fmul_rn(xv, __ldg(a.w + (int64_t)i * a.d + c)));
    }
    yc[(int64_t)t * a.y_sl] = acc;
  }
}

template <int K>
int launch(const Conv1dArgs &a, dim3 grid, int tile_d, void *stream) {
  trim_conv1d_kernel<K><<<grid, tile_d, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
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
  if (b < 1 || b > 65535 || length < 1 || d < 1 || k < 2 ||
      tile_l < 1 || tile_d < 32 || tile_d > kMaxThreads || tile_d % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t runs = ((int64_t)length + tile_l - 1) / tile_l;
  const int64_t d_tiles = ((int64_t)d + tile_d - 1) / tile_d;
  if (runs > 2147483647 || d_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  Conv1dArgs a;
  a.x = x; a.w = w; a.y = y;
  a.length = length; a.d = d; a.tile_l = tile_l;
  a.x_sb = x_sb; a.x_sl = x_sl; a.y_sb = y_sb; a.y_sl = y_sl;
  const dim3 grid((unsigned)runs, (unsigned)d_tiles, (unsigned)b);
  switch (k) {
    case 2: return launch<2>(a, grid, tile_d, stream);
    case 3: return launch<3>(a, grid, tile_d, stream);
    case 4: return launch<4>(a, grid, tile_d, stream);
    case 5: return launch<5>(a, grid, tile_d, stream);
    case 6: return launch<6>(a, grid, tile_d, stream);
    case 7: return launch<7>(a, grid, tile_d, stream);
    case 8: return launch<8>(a, grid, tile_d, stream);
    default:
      trim_conv1d_any_k<<<grid, tile_d, 0,
                          static_cast<cudaStream_t>(stream)>>>(a, k);
      return (int)cudaGetLastError();
  }
}

const char *trim_conv1d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
