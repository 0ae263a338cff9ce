// Weight gradient of the causal depthwise conv1d for NVIDIA Hopper
// (sm_90a), f32 and bf16, hand-written CUDA.
//
// Replaces no Pallas kernel: the JAX package differentiates
// ref.depthwise_conv1d (src/repro/models/mamba.py:110, rglru.py:66) by
// XLA's autodiff and has no conv1d backward kernel.  It is the backward
// of the forward kernel of csrc/trim_conv1d.cu (which replaces _kernel of
// src/repro/kernels/trim_conv1d.py:29), for the ssm and hybrid training
// steps.  The input gradient needs no kernel of its own: it is the
// forward kernel (f32 or bf16) launched on the time-reversed cotangent
// (the wrapper passes the last row and a negated time stride), with the
// same taps in the same order.
//
//   dw[i, d] = sum over (b, t) of x[b, t-K+1+i, d] * dy[b, t, d],
//
// with zero left padding.
//
// What bounds it on the H100.  Bytes: x and dy are read once, 2 K FLOPs
// per (b, t, d) against 8 bytes (4 in bf16).  At recurrentgemma-2b's
// training shape (B 1, L 4096, D 2560, K 4) that is 83.9 MB in f32, 0.0251
// ms at 3.35 TB/s (41.9 MB, 0.0125 ms in bf16).  The first design (one
// channel a lane, runs of 8 steps, 64 groups there) moved 104.9 MB at
// about 1.7 TB/s: 4-byte loads left each thread a few bytes in flight, and
// each run of 8 re-read a 3-row halo (37% more x).
//
// The design (core/conv_plan.py, Conv1dWeightGradPlan).
// (1) A lane owns kVec consecutive channels where the rows are 16-byte
// aligned (D, the strides and the pointers: 4 f32 or 8 bf16 channels, one
// 16-byte load a row of x and of dy); elsewhere one channel.  A warp's row
// loads are 512 contiguous bytes.
// (2) The (b, t) axis is cut into runs of tile_l steps, each within one
// sequence (a run's window starts from the K-1 inputs before it, zeros
// before t = 0, so it resets at every b).  The plan takes the longest run
// that still gives 2 blocks an SM, but never one whose K-1 halo rows pass
// a tenth of it: 64 steps in f32 and 32 in bf16 at both training rows
// (recurrentgemma-2b's and falcon-mamba-7b's (2, 1024, 8192)), 320 and 512
// blocks, the whole grid resident at once.
// (3) A thread walks its run with the K-1 previous inputs of its channels
// in registers (the shadow registers) and K accumulators a channel.  It
// loads kUnroll rows of x and dy at a time and issues the next batch's
// loads before it sums the current one, so two batches (256 bytes) are in
// flight a thread: ~40,000 threads keep ~10 MB in flight, several times
// what covers the latency of HBM at 3.35 TB/s.
// (4) The runs are numbered b-major and taken kRuns at a time: a block of
// kRuns warps holds one group of consecutive runs (one a warp) and tile_d
// = 32 kVec channels.  The block adds its warps' accumulators in warp (=
// run) order through shared memory, from 0, and writes one f32 partial (K,
// tile_d) of the group into scratch; a second kernel adds the groups'
// partials in group order, from 0, and rounds once to dw's dtype.
//
// Determinism.  No float atomics: every dw element is one fixed sequence of
// rounded f32 adds that the plan decides (the run's steps in time order,
// then the group's runs in order, then the groups in order), so two calls
// are bitwise equal, and the plain version (trim_conv1d_wgrad_plain),
// which replays the same runs, groups and orders, equals the kernel bit
// for bit whatever kVec is.  Every product is rounded before its add
// (__fmul_rn, __fadd_rn), as in the forward: nvcc may not contract them
// into an FMA.
//
// bf16 (trim_conv1d_wgrad_bf16).  x and dy are read as bf16 and widened
// exactly to f32 (a bf16 value's 16 bits are the high half of the f32), so
// each product is exact in f32; the sums, the partials and their order are
// the f32 route's, and the one rounding to bf16 is at dw's store.
//
// Any K >= 2: K = 2..8 keep the window and the accumulators in registers
// (a template instance each); a larger K runs trim_conv1d_wgrad_any_k,
// which re-reads the window through L1 and accumulates in shared memory,
// in the same order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace {

constexpr int kRuns = 4;       // warps (runs) a block: CONV1D_WGRAD_RUNS
constexpr int kLanes = 32;     // channel vectors a warp: CONV1D_WGRAD_LANES
constexpr int kThreads = kRuns * kLanes;
constexpr int kVecF32 = 4;     // f32 channels a lane, 16-byte rows
constexpr int kVecBf16 = 8;    // bf16 channels a lane, 16-byte rows
constexpr int kUnroll = 4;     // rows of a load batch: CONV1D_WGRAD_UNROLL
constexpr int kMaxUnrolledK = 8;   // CONV1D_UNROLLED_K
constexpr int kSumThreads = 256;   // CONV1D_WGRAD_SUM_THREADS
constexpr int kMaxSmemBytes = 232448;   // CONV1D_WGRAD_MAX_SMEM

template <typename T>
struct WgradArgs {
  const T *x, *dy;
  float *partial;               // (groups, K, D)
  int length, d, k, tile_l, runs_per_b, runs;
  int64_t x_sb, x_sl, g_sb, g_sl;   // strides in elements
};

// One row of a lane's V channels: the raw bits a load brings (Raw) and
// their f32 values (widen).
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
};

// The thread's run: [t0, t1) of sequence b over channels c0 .. c0 + V - 1,
// or an empty run past the last run or D.
template <typename T>
struct Run {
  const T *xc, *gc;
  int t0, t1;
};

template <typename T>
__device__ __forceinline__ Run<T> run_of(const WgradArgs<T> &a, int run,
                                         int c0) {
  Run<T> r{nullptr, nullptr, 0, 0};
  if (run >= a.runs || c0 >= a.d) return r;
  const int b = run / a.runs_per_b;
  r.t0 = (run - b * a.runs_per_b) * a.tile_l;
  r.t1 = min(r.t0 + a.tile_l, a.length);
  r.xc = a.x + (int64_t)b * a.x_sb + c0;
  r.gc = a.dy + (int64_t)b * a.g_sb + c0;
  return r;
}

// The group's ordered sum of its warps' sums red[warp][i][channel], from
// 0, into the group's partial; every thread of the block takes elements.
template <typename T, int V>
__device__ __forceinline__ void group_sum(const WgradArgs<T> &a,
                                          const float *red, int k) {
  constexpr int kTileD = kLanes * V;
  const int d0 = blockIdx.y * kTileD;
  for (int e = threadIdx.x; e < k * kTileD; e += kThreads) {
    const int i = e / kTileD, c = d0 + e % kTileD;
    if (c >= a.d) continue;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kRuns; ++w) s = __fadd_rn(s, red[w * k * kTileD + e]);
    a.partial[((int64_t)blockIdx.x * k + i) * a.d + c] = s;
  }
}

template <typename T, int K, int V>
__global__ void __launch_bounds__(kThreads)
    trim_conv1d_wgrad_kernel(const WgradArgs<T> a) {
  using R = Row<T, V>;
  constexpr int kTileD = kLanes * V;
  extern __shared__ float red[];    // [warp][i][channel of the tile]
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int c0 = blockIdx.y * kTileD + lane * V;
  const Run<T> r = run_of(a, blockIdx.x * kRuns + warp, c0);
  float acc[K][V];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int c = 0; c < V; ++c) acc[i][c] = 0.0f;
  if (r.t1 > r.t0) {
    // the shadow registers: the K-1 inputs before the run
    float win[K][V];
#pragma unroll
    for (int i = 0; i < K - 1; ++i) {
      const int t = r.t0 - (K - 1) + i;
      typename R::Raw raw{};
      if (t >= 0) raw = R::load(r.xc + (int64_t)t * a.x_sl);
      R::widen(raw, win[i]);
    }
    // batches of kUnroll rows; the next batch is loaded before this one
    // is summed
    typename R::Raw xin[kUnroll], gin[kUnroll];
    auto load = [&](int tb, typename R::Raw (&xr)[kUnroll],
                    typename R::Raw (&gr)[kUnroll]) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        xr[u] = typename R::Raw{};
        gr[u] = typename R::Raw{};
        if (tb + u < r.t1) {
          xr[u] = R::load(r.xc + (int64_t)(tb + u) * a.x_sl);
          gr[u] = R::load(r.gc + (int64_t)(tb + u) * a.g_sl);
        }
      }
    };
    load(r.t0, xin, gin);
    for (int tb = r.t0; tb < r.t1; tb += kUnroll) {
      typename R::Raw xn[kUnroll], gn[kUnroll];
      if (tb + kUnroll < r.t1) load(tb + kUnroll, xn, gn);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float g[V];
        R::widen(xin[u], win[K - 1]);
        R::widen(gin[u], g);
        if (tb + u < r.t1) {
#pragma unroll
          for (int i = 0; i < K; ++i)
#pragma unroll
            for (int c = 0; c < V; ++c)
              acc[i][c] = __fadd_rn(acc[i][c], __fmul_rn(win[i][c], g[c]));
        }
#pragma unroll
        for (int i = 0; i < K - 1; ++i)
#pragma unroll
          for (int c = 0; c < V; ++c) win[i][c] = win[i + 1][c];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        xin[u] = xn[u];
        gin[u] = gn[u];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int c = 0; c < V; ++c)
      red[(warp * K + i) * kTileD + lane * V + c] = acc[i][c];
  __syncthreads();
  group_sum<T, V>(a, red, K);
}

// K as an argument: the window re-read through L1, the accumulators in
// shared memory (red[warp][i][channel], each touched by its own thread
// only until the barrier); the same products added in the same order.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    trim_conv1d_wgrad_any_k(const WgradArgs<T> a) {
  using R = Row<T, V>;
  constexpr int kTileD = kLanes * V;
  extern __shared__ float red[];
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int c0 = blockIdx.y * kTileD + lane * V;
  const Run<T> r = run_of(a, blockIdx.x * kRuns + warp, c0);
  float *acc = red + warp * a.k * kTileD + lane * V;
  for (int i = 0; i < a.k; ++i)
#pragma unroll
    for (int c = 0; c < V; ++c) acc[i * kTileD + c] = 0.0f;
  for (int t = r.t0; t < r.t1; ++t) {
    float g[V];
    R::widen(R::load(r.gc + (int64_t)t * a.g_sl), g);
    for (int i = 0; i < a.k; ++i) {
      const int tt = t - (a.k - 1) + i;
      typename R::Raw raw{};
      if (tt >= 0) raw = R::load(r.xc + (int64_t)tt * a.x_sl);
      float xv[V];
      R::widen(raw, xv);
#pragma unroll
      for (int c = 0; c < V; ++c)
        acc[i * kTileD + c] =
            __fadd_rn(acc[i * kTileD + c], __fmul_rn(xv[c], g[c]));
    }
  }
  __syncthreads();
  group_sum<T, V>(a, red, a.k);
}

// dw[e] = the groups' partials of element e (of K * D) added in group
// order, from 0, rounded once to dw's type.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
    trim_conv1d_wgrad_sum(const float *__restrict__ partial,
                          T *__restrict__ dw, const int groups,
                          const int64_t elems) {
  const int64_t e = (int64_t)blockIdx.x * kSumThreads + threadIdx.x;
  if (e >= elems) return;
  const float *p = partial + e;
  float s = 0.0f;
  int g = 0;
  for (; g + 8 <= groups; g += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = __ldg(p + (g + u) * elems);
#pragma unroll
    for (int u = 0; u < 8; ++u) s = __fadd_rn(s, v[u]);
  }
  for (; g < groups; ++g) s = __fadd_rn(s, __ldg(p + g * elems));
  store_elem(dw + e, s);
}

template <typename T, int V>
int launch_runs(const WgradArgs<T> &a, dim3 grid, size_t smem,
                cudaStream_t s) {
  auto go = [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, kThreads, smem, s>>>(a);
    return (int)cudaGetLastError();
  };
  switch (a.k) {
    case 2: return go(trim_conv1d_wgrad_kernel<T, 2, V>);
    case 3: return go(trim_conv1d_wgrad_kernel<T, 3, V>);
    case 4: return go(trim_conv1d_wgrad_kernel<T, 4, V>);
    case 5: return go(trim_conv1d_wgrad_kernel<T, 5, V>);
    case 6: return go(trim_conv1d_wgrad_kernel<T, 6, V>);
    case 7: return go(trim_conv1d_wgrad_kernel<T, 7, V>);
    case 8: return go(trim_conv1d_wgrad_kernel<T, 8, V>);
    default: return go(trim_conv1d_wgrad_any_k<T, V>);
  }
}

// The checks and both launches of one call (see the entry points below).
template <typename T>
int run(const T *x, const T *dy, float *partial, T *dw, int b, int length,
        int d, int k, int64_t x_sb, int64_t x_sl, int64_t g_sb,
        int64_t g_sl, int tile_l, int groups, int vec, void *stream) {
  constexpr int kVec = sizeof(T) == 4 ? kVecF32 : kVecBf16;
  if (b < 1 || length < 1 || d < 1 || k < 2 || tile_l < 1 ||
      (vec != 1 && vec != kVec))
    return (int)cudaErrorInvalidValue;
  // 16-byte rows: D, the strides and the pointers multiples of vec
  const auto al16 = [](const void *p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (vec != 1 && (d % vec || x_sb % vec || x_sl % vec || g_sb % vec ||
                   g_sl % vec || !al16(x) || !al16(dy)))
    return (int)cudaErrorInvalidValue;
  const int64_t runs_per_b = ((int64_t)length + tile_l - 1) / tile_l;
  const int64_t runs = runs_per_b * b;
  const int64_t tile_d = (int64_t)kLanes * vec;
  const int64_t d_tiles = ((int64_t)d + tile_d - 1) / tile_d;
  // the plan's group count must be the kernels' own
  if (runs > 2147483647 || groups != (runs + kRuns - 1) / kRuns ||
      d_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t smem = (int64_t)kRuns * k * tile_d * sizeof(float);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  WgradArgs<T> a;
  a.x = x; a.dy = dy; a.partial = partial;
  a.length = length; a.d = d; a.k = k; a.tile_l = tile_l;
  a.runs_per_b = (int)runs_per_b; a.runs = (int)runs;
  a.x_sb = x_sb; a.x_sl = x_sl; a.g_sb = g_sb; a.g_sl = g_sl;
  const dim3 grid((unsigned)groups, (unsigned)d_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = vec == 1 ? launch_runs<T, 1>(a, grid, (size_t)smem, s)
                           : launch_runs<T, kVec>(a, grid, (size_t)smem, s);
  if (err != 0) return err;
  const int64_t elems = (int64_t)k * d;
  trim_conv1d_wgrad_sum<T>
      <<<(unsigned)((elems + kSumThreads - 1) / kSumThreads), kSumThreads, 0,
         s>>>(partial, dw, groups, elems);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes by repro_torch/kernels/build.py.  Two
// launches on `stream` without synchronising (the runs' groups into
// `partial`, then their ordered sum into `dw`); returns
// cudaGetLastError() of the first that fails, or cudaErrorInvalidValue
// for a geometry the kernels cannot take.  x, dy: (B, L, D) with channel
// stride 1 and strides x_sb, x_sl / g_sb, g_sl; partial: (groups, K, D)
// f32 scratch, groups = ceil(B * ceil(L / tile_l) / kRuns); dw: (K, D)
// contiguous, of the operands' type; vec: channels a lane, 1 or kVecF32 /
// kVecBf16 (16-byte rows, checked here).
extern "C" {

int trim_conv1d_wgrad_f32(const float *x, const float *dy, float *partial,
                          float *dw, int b, int length, int d, int k,
                          int64_t x_sb, int64_t x_sl, int64_t g_sb,
                          int64_t g_sl, int tile_l, int groups, int vec,
                          void *stream) {
  return run<float>(x, dy, partial, dw, b, length, d, k, x_sb, x_sl, g_sb,
                    g_sl, tile_l, groups, vec, stream);
}

int trim_conv1d_wgrad_bf16(const __nv_bfloat16 *x, const __nv_bfloat16 *dy,
                           float *partial, __nv_bfloat16 *dw, int b,
                           int length, int d, int k, int64_t x_sb,
                           int64_t x_sl, int64_t g_sb, int64_t g_sl,
                           int tile_l, int groups, int vec, void *stream) {
  return run<__nv_bfloat16>(x, dy, partial, dw, b, length, d, k, x_sb, x_sl,
                            g_sb, g_sl, tile_l, groups, vec, stream);
}

const char *trim_conv1d_wgrad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
