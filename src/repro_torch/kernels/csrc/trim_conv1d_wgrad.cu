// Weight gradient of the causal depthwise conv1d for NVIDIA Hopper
// (sm_90a), f32, hand-written CUDA.
//
// Replaces no Pallas kernel: the JAX package differentiates
// ref.depthwise_conv1d (src/repro/models/mamba.py:110, rglru.py:66) by
// XLA's autodiff and has no conv1d backward kernel.  It is the backward
// of the forward kernel of csrc/trim_conv1d.cu (which replaces _kernel of
// src/repro/kernels/trim_conv1d.py:29), for the ssm and hybrid training
// steps.  The input gradient needs no kernel of its own: it is the
// forward kernel launched on the time-reversed cotangent (the wrapper
// passes the last row and a negated time stride), with the same taps in
// the same order.
//
//   dw[i, d] = sum over (b, t) of x[b, t-K+1+i, d] * dy[b, t, d],
//
// with zero left padding.
//
// Geometry (core/conv_plan.py, Conv1dWeightGradPlan).  The (b, t) axis is
// cut into runs of tile_l steps, each within one sequence (a run's window
// starts from the K-1 inputs before it, zeros before t = 0, so it resets
// at every b).  The runs are numbered b-major and taken kRuns at a time:
// a block of kRuns warps x 32 lanes holds one group of kRuns consecutive
// runs (one a warp) and 32 consecutive channels (one a lane, so a warp's
// loads of a row are 128 contiguous bytes).  A thread walks its run as
// the forward does, the K-1 previous inputs of its channel in registers
// (the shadow registers), and keeps K accumulators.  The block then adds
// its warps' accumulators in warp (= run) order through shared memory and
// writes one partial (K, 32) of the group into scratch; a second kernel
// adds the groups' partials in group order.  No float atomics: every dw
// element is one fixed sequence of rounded adds, so two calls are
// bitwise equal, and the plain version (trim_conv1d_wgrad_plain), which
// replays the same runs, groups and orders, equals the kernel bit for
// bit.  Every product is rounded before its add (__fmul_rn, __fadd_rn),
// as in the forward: nvcc may not contract them into an FMA.
//
// What bounds it on the H100.  Bytes: x and dy are read once, 2 K FLOPs
// per (b, t, d) against 8 bytes.  At recurrentgemma-2b's training shape
// (B 1, L 4096, D 2560, K 4) that is 83.9 MB, 0.025 ms at 3.35 TB/s.  The
// design does nothing beyond the forward's load-ahead (kUnroll rows of x
// and dy in flight a thread) for speed: the runs' halos (K-1 rows a run,
// mostly L2 hits) and the partials (groups x K x D floats, written and
// read once) are its extra traffic.
//
// Any K >= 2: K = 2..8 keep the window and the accumulators in registers
// (a template instance each); a larger K runs trim_conv1d_wgrad_any_k,
// which re-reads the window through L1 and accumulates in shared memory,
// in the same order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRuns = 8;       // warps (runs) a block: CONV1D_WGRAD_RUNS
constexpr int kLanes = 32;     // channels a block: CONV1D_WGRAD_TILE_D
constexpr int kThreads = kRuns * kLanes;
constexpr int kUnroll = 8;     // timesteps loaded ahead by each thread
constexpr int kMaxUnrolledK = 8;   // CONV1D_UNROLLED_K
constexpr int kSumThreads = 256;   // CONV1D_WGRAD_SUM_THREADS

struct WgradArgs {
  const float *x, *dy;
  float *partial;               // (groups, K, D)
  int length, d, k, tile_l, runs_per_b, runs;
  int64_t x_sb, x_sl, g_sb, g_sl;   // strides in elements
};

// The thread's run: [t0, t1) of sequence b, or an empty run past the last.
struct Run {
  const float *xc, *gc;
  int t0, t1;
};

__device__ __forceinline__ Run run_of(const WgradArgs &a, int run, int c) {
  Run r{nullptr, nullptr, 0, 0};
  if (run >= a.runs || c >= a.d) return r;
  const int b = run / a.runs_per_b;
  r.t0 = (run - b * a.runs_per_b) * a.tile_l;
  r.t1 = min(r.t0 + a.tile_l, a.length);
  r.xc = a.x + (int64_t)b * a.x_sb + c;
  r.gc = a.dy + (int64_t)b * a.g_sb + c;
  return r;
}

// The group's ordered sum of its warps' accumulators red[warp][i][lane]:
// lanes of warp 0 write the group's partial.
__device__ __forceinline__ void group_sum(const WgradArgs &a,
                                          const float *red, int k, int c) {
  const int lane = threadIdx.x % kLanes;
  if (threadIdx.x >= kLanes || c >= a.d) return;
  for (int i = 0; i < k; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kRuns; ++w)
      s = __fadd_rn(s, red[(w * k + i) * kLanes + lane]);
    a.partial[((int64_t)blockIdx.x * k + i) * a.d + c] = s;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    trim_conv1d_wgrad_kernel(const WgradArgs a) {
  __shared__ float red[kRuns * K * kLanes];
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int c = blockIdx.y * kLanes + lane;
  const Run r = run_of(a, blockIdx.x * kRuns + warp, c);
  float acc[K];
#pragma unroll
  for (int i = 0; i < K; ++i) acc[i] = 0.0f;
  if (r.t1 > r.t0) {
    // the shadow registers: the K-1 inputs before the run
    float win[K];
#pragma unroll
    for (int i = 0; i < K - 1; ++i) {
      const int t = r.t0 - (K - 1) + i;
      win[i] = t >= 0 ? __ldg(r.xc + (int64_t)t * a.x_sl) : 0.0f;
    }
    for (int tb = r.t0; tb < r.t1; tb += kUnroll) {
      float in[kUnroll], g[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool ok = tb + u < r.t1;
        in[u] = ok ? __ldg(r.xc + (int64_t)(tb + u) * a.x_sl) : 0.0f;
        g[u] = ok ? __ldg(r.gc + (int64_t)(tb + u) * a.g_sl) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        win[K - 1] = in[u];
        if (tb + u < r.t1) {
#pragma unroll
          for (int i = 0; i < K; ++i)
            acc[i] = __fadd_rn(acc[i], __fmul_rn(win[i], g[u]));
        }
#pragma unroll
        for (int i = 0; i < K - 1; ++i) win[i] = win[i + 1];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) red[(warp * K + i) * kLanes + lane] = acc[i];
  __syncthreads();
  group_sum(a, red, K, c);
}

// K as an argument: the window re-read through L1, the accumulators in
// shared memory (red[warp][i][lane], each touched by its own thread only
// until the barrier); the same products added in the same order.
__global__ void __launch_bounds__(kThreads)
    trim_conv1d_wgrad_any_k(const WgradArgs a) {
  extern __shared__ float red[];
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int c = blockIdx.y * kLanes + lane;
  const Run r = run_of(a, blockIdx.x * kRuns + warp, c);
  float *acc = red + warp * a.k * kLanes + lane;
  for (int i = 0; i < a.k; ++i) acc[i * kLanes] = 0.0f;
  for (int t = r.t0; t < r.t1; ++t) {
    const float g = __ldg(r.gc + (int64_t)t * a.g_sl);
    for (int i = 0; i < a.k; ++i) {
      const int tt = t - (a.k - 1) + i;
      const float xv = tt >= 0 ? __ldg(r.xc + (int64_t)tt * a.x_sl) : 0.0f;
      acc[i * kLanes] = __fadd_rn(acc[i * kLanes], __fmul_rn(xv, g));
    }
  }
  __syncthreads();
  group_sum(a, red, a.k, c);
}

// dw[e] = the groups' partials of element e (of K * D) added in group
// order, from 0.
__global__ void __launch_bounds__(kSumThreads)
    trim_conv1d_wgrad_sum(const float *__restrict__ partial,
                          float *__restrict__ dw, const int groups,
                          const int64_t elems) {
  const int64_t e = (int64_t)blockIdx.x * kSumThreads + threadIdx.x;
  if (e >= elems) return;
  const float *p = partial + e;
  float s = 0.0f;
  int g = 0;
  for (; g + kUnroll <= groups; g += kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(p + (g + u) * elems);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) s = __fadd_rn(s, v[u]);
  }
  for (; g < groups; ++g) s = __fadd_rn(s, __ldg(p + g * elems));
  dw[e] = s;
}

template <int K>
int launch(const WgradArgs &a, dim3 grid, cudaStream_t stream) {
  trim_conv1d_wgrad_kernel<K><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes by repro_torch/kernels/build.py.  Two
// launches on `stream` without synchronising (the runs' groups into
// `partial`, then their ordered sum into `dw`); returns
// cudaGetLastError() of the first that fails, or cudaErrorInvalidValue
// for a geometry the kernels cannot take.  x, dy: (B, L, D) with channel
// stride 1 and strides x_sb, x_sl / g_sb, g_sl; partial: (groups, K, D)
// scratch, groups = ceil(B * ceil(L / tile_l) / 8); dw: (K, D)
// contiguous.
extern "C" {

int trim_conv1d_wgrad_f32(const float *x, const float *dy, float *partial,
                          float *dw, int b, int length, int d, int k,
                          int64_t x_sb, int64_t x_sl, int64_t g_sb,
                          int64_t g_sl, int tile_l, int groups,
                          void *stream) {
  if (b < 1 || length < 1 || d < 1 || k < 2 || tile_l < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t runs_per_b = ((int64_t)length + tile_l - 1) / tile_l;
  const int64_t runs = runs_per_b * b;
  const int64_t d_tiles = ((int64_t)d + kLanes - 1) / kLanes;
  // the plan's group count must be the kernels' own
  if (runs > 2147483647 || groups != (runs + kRuns - 1) / kRuns ||
      d_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t smem = (int64_t)kRuns * k * kLanes * sizeof(float);
  if (k > kMaxUnrolledK && smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  WgradArgs a;
  a.x = x; a.dy = dy; a.partial = partial;
  a.length = length; a.d = d; a.k = k; a.tile_l = tile_l;
  a.runs_per_b = (int)runs_per_b; a.runs = (int)runs;
  a.x_sb = x_sb; a.x_sl = x_sl; a.g_sb = g_sb; a.g_sl = g_sl;
  const dim3 grid((unsigned)groups, (unsigned)d_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (k) {
    case 2: err = launch<2>(a, grid, s); break;
    case 3: err = launch<3>(a, grid, s); break;
    case 4: err = launch<4>(a, grid, s); break;
    case 5: err = launch<5>(a, grid, s); break;
    case 6: err = launch<6>(a, grid, s); break;
    case 7: err = launch<7>(a, grid, s); break;
    case 8: err = launch<8>(a, grid, s); break;
    default:
      trim_conv1d_wgrad_any_k<<<grid, kThreads, (size_t)smem, s>>>(a);
      err = (int)cudaGetLastError();
  }
  if (err != 0) return err;
  const int64_t elems = (int64_t)k * d;
  trim_conv1d_wgrad_sum<<<(unsigned)((elems + kSumThreads - 1) /
                                     kSumThreads),
                          kSumThreads, 0, s>>>(partial, dw, groups, elems);
  return (int)cudaGetLastError();
}

const char *trim_conv1d_wgrad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
