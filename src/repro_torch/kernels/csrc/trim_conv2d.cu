// 3D-TrIM convolution for NVIDIA Hopper (sm_90a), f32 and bf16,
// hand-written CUDA.
//
// Replaces the TPU Pallas kernels of src/repro/kernels/trim_conv2d.py:
//   trim_conv2d_carry -> _carry_kernel (:127), with _tap_matmuls (:82) and
//                        _epilogue_store (:105), dataflow="carry"
//   trim_conv2d_halo  -> _halo_kernel (:162), dataflow="halo"
//   trim_conv2d_carry_bf16, trim_conv2d_halo_bf16 -> the same kernels on
//                        bf16 operands (their out dtype is the input's, :355)
// Every entry launches one kernel template for its route: the two
// dataflows differ only in how many strips one block walks (see Segments).
//
// Math.  y[n,oh,ow,g*Cpg+co] = act(bias + sum_{ki,kj,ci} xpad[n, oh*s+ki,
// ow*s+kj, g*Cin_pg+ci] * w[ki,kj,ci,g*Cpg+co]), ki < KH, kj < KW: a square
// kernel, or a rectangular sub-kernel of the kernel tiling (an 11 x 11
// kernel runs as 3x3, 3x2, 2x3 and 2x2 pieces, kernels/ops.py).  Each
// output element's sum is taken in one fixed order that depends on nothing
// but the element, so carry and halo are bitwise equal, a row's result
// does not depend on the batch it was served in, and the fused kernel
// (trim_conv2d_fused.cu), which takes the same order, equals a chain of
// these launches bit for bit.  No split of a sum across threads or blocks.
//
// Routes.  f32 (trim_conv2d_kernel<float>): ONE fp32 fmaf chain started
// from 0 in (ki, then kj, then ci ascending over all of Cin/g) order, then
// + bias (a separate add), then activate() of epilogue.cuh; FFMA, no
// tensor cores (TF32 would change the chain).  bf16 takes one of two
// routes, a function of Cin/g alone (core/conv_plan.py, bf16_route),
// passed by the plan and checked by the launcher:
//  * mma (Cin/g a multiple of 16: VGG-16 conv2-13, AlexNet conv2-5, their
//    input gradients): trim_conv2d_mma_kernel, an implicit GEMM on the
//    bf16 tensor cores whose every output is the k-order of bf16_mma.cuh:
//    mma.sync m16n8k16 k-steps over the (ki, kj) taps and ascending runs
//    of 16 channels into one f32 accumulator, + bias, activate(), one
//    __float2bfloat16_rn at the store.  Products are exact and the sum is
//    f32, as in JAX's bf16 function (_tap_matmuls' f32 accumulation, one
//    cast at _epilogue_store), in the tensor core's order of addition.
//  * ffma (other Cin/g: the Cin-3 first layers, depthwise, AlexNet conv1's
//    sub-kernels): trim_conv2d_kernel<__nv_bfloat16>, the f32 kernel's
//    fmaf chain on bf16 rings, each value widened exactly on read
//    (elem.cuh), one rounding at the store.  Its window loads 8 channels
//    a 16-byte copy where Cin/g is a multiple of 8 (pitch Cin/g + 8), else
//    element by element (cp.async copies no 2-byte unit); weights move as
//    8-byte copies of 4 output channels.
//
// Geometry (core/conv_plan.py, ConvPlan).  A block owns (image n, group g,
// C_out tile, column band of TW output columns) -- a chain -- and one
// segment of that band's strips.  Its input window, TH + (KH-s) padded rows
// x WC = (TW-1)*s + KW columns x all Cin/g channels, lives in shared memory
// as a ring of row slots (slot = padded row mod ring_rows), so strip t+1
// reuses the KH-s rows strip t already holds without moving them: the
// shadow registers (none where KH <= s, as at a stride-4 sub-kernel of
// AlexNet's conv1: each strip then loads its rows fresh).  'same'/'valid'
// padding is virtual: the loader zero-fills outside the image, and ragged
// bottom/right edges are masked at the store.
//
// Segments.  The TPU walks the strips of a band in order on one core.
// Here a band's strips are cut into `segments` runs, one block each: a
// block loads its first window whole, then only the TH fresh rows of each
// further strip.  carry takes the fewest segments that fill a wave of
// resident blocks on the 132 SMs; halo is the limit of one strip a
// segment (each block re-reads its KH-s predecessor rows).  When a segment
// walks several strips and shared memory allows, the ring has 2 TH + (KH-s)
// slots and the next strip's fresh rows are copied in, a slice with each
// weight stage, while this strip computes.
//
// Threads, f32 and route ffma.  256 threads as tcx = ceil(tile_cout / 4)
// along C_out x 256 / tcx along positions; a thread holds kPositions = 8
// output positions x kCout = 4 channels of fp32 accumulators (32),
// positions ty + m * (256 / tcx).  For each group of 4 input channels it
// issues 8 float4 window loads (the lanes of a warp along C_out read the
// same positions: broadcasts; the window's channel pitch is Cin/g + 4 so
// that the 2-4 positions of a warp fall on different banks) and 4 float4
// weight loads, for 128 FMAs.
// Weights stream through a 2-stage ring of [16 input channels of one tap]
// x [tile_cout] filled by cp.async: stage c+1 lands while stage c
// computes, one barrier a stage.  Window rows also arrive by cp.async
// (16-byte copies where Cin/g is a multiple of 4, zero-filled padding).
// A window too large for two blocks an SM runs an instance compiled for
// one block, which may use more than 128 registers.
//
// Warps, route mma (the int8 kernel's mma route, trim_conv2d_q8.cu, on
// bf16).  M = the strip's positions, N = the C_out tile, K = the
// contract's k-steps.  8 warps as warps_m x warps_n, each with m_frags m16
// x 4 n8 f32 fragments in registers (instances of up to 4 fragments, one
// block an SM, and up to 2, two blocks an SM in 128 registers); no split
// of K.  A comes by ldmatrix.x4 straight from the window ring: each lane
// gives the address of one position's 8 channels at the k-step's tap, so
// the implicit-GEMM gather costs nothing.  The window's columns are stored
// phase-split by the stride (column c at slot (c % s) * ceil(cols / s) +
// c / s), so positions one output column apart are one pitch apart at
// every tap, and the pitch Cin/g + 8 is an odd count of 16-byte quads: the
// 8 rows of an ldmatrix phase hit 8 distinct bank quads; each ring row is
// padded so that a phase which crosses output rows does too.  B comes by
// ldmatrix.x4.trans from a 3-stage cp.async ring of [4 k-steps = 64
// (tap, channel) rows] x [32 warps_n output channels + 8] bf16, the
// weights' own k-major rows (zeros past the tile's valid channels).  The
// next k-step's fragments load before this one's products
// (bf16_mma_steps).  Epilogue: bias, activate() and the rounding on the C
// fragments, each warp's m16 x 32 staged in shared memory, then 16-byte
// stores, 8 channels a lane.
//
// What bounds it on the H100.  At VGG-16 shapes the conv does hundreds of
// FLOPs per byte it must move, so the function is bound by operations: 67
// TFLOP/s of non-tensor f32, 989 TFLOP/s of bf16 on the tensor cores
// (mma.sync reaches part of it; wgmma would be the next design).  The f32
// design aims at the FFMA pipes: 32 independent accumulator chains a
// thread, few shared-memory loads per FMA, copies off the critical path,
// and enough blocks to fill the SMs.  At Cin/g = 512 the window of an 8 x 8
// strip (10 x 10 x 516 floats, 206 KB) takes the whole shared memory, so
// such layers run one block (8 warps) an SM.  The mma route, like the int8
// one, is bound by latency (a weight stage's k-steps and copies in
// series), far below the tensor cores' rate.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "cp_async.cuh"
#include "elem.cuh"
#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;        // threads per block (CONV_THREADS)
constexpr int kPositions = 8;        // output positions a thread
constexpr int kCout = 4;             // output channels a thread (a float4)
constexpr int kChunk = 16;           // input channels of one tap a stage
constexpr int kStages = 2;           // weight ring stages
constexpr int kMaxSmemBytes = 232448;  // H100: 227 KB opt-in per block
constexpr int kSmemPerSm = 233472;     // H100: 228 KB an SM
constexpr int kReservedSmem = 1024;    // the runtime's share of each block
// bf16, route mma (kBf16* of bf16_mma.cuh)
constexpr int kWarps = 8;              // warps per block
constexpr int kMmaMaxMFrags = 4;       // m16 fragments a warp at most ...
constexpr int kMmaMFragsTwo = 2;       // ... in the two-blocks-an-SM instance
constexpr int kMmaStageSteps = 4;      // k-steps of one weight stage
constexpr int kMmaStages = 3;          // the weight ring's stages
constexpr int kMmaStagingPitch = kBf16WarpN + 8;  // bf16 a staging row

enum Bf16Route { kRouteFfma = 0, kRouteMma = 1 };

struct ConvArgs {
  int n, h, w, cin, cout, kh, kw, stride, pad_top, pad_left, groups;
  int h_out, w_out;
  int tile_h_out;    // output rows per strip
  int tile_w;        // output columns per band
  int tile_cout;     // output channels per block
  int strips_per_seg;
  int ring_rows;     // window ring slots (>= TH + KH-s)
  int cin_stride;    // window channel pitch (>= Cin/g)
  int n_strips, n_bands, co_tiles, segments;
  int tcx;           // threads along C_out: ceil(tile_cout / 4)
  int vec_w;         // 16-byte weight copies
  int activation;    // activate()'s code (epilogue.cuh)
  int route;         // bf16: Bf16Route (the plan's; checked by the launcher)
  int warps_n, m_frags;   // route mma: warps along C_out, m16 fragments
  // route mma, derived by launch_bf16()
  int vec_x, vec_y;  // 16-byte window copies, 16-byte output stores
  int k_steps;       // k-steps a strip: KH * KW * Cin/g / 16
  int n_st;          // weight stages a strip
};

__host__ __device__ inline int window_cols(const ConvArgs& a) {
  return (a.tile_w - 1) * a.stride + a.kw;
}

// Elements of the window ring, rounded to 16 bytes so the weights align.
template <typename T>
__host__ __device__ inline int window_elems(const ConvArgs& a) {
  constexpr int kAlign = 16 / (int)sizeof(T);
  return (a.ring_rows * window_cols(a) * a.cin_stride + kAlign - 1) /
         kAlign * kAlign;
}

template <typename T>
inline size_t smem_bytes(const ConvArgs& a) {
  return ((size_t)window_elems<T>(a) + (size_t)kStages * kChunk * 4 * a.tcx) *
         sizeof(T);
}

// T: float or __nv_bfloat16, the element type of x, w, bias and y.
template <typename T, bool kVecX, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
trim_conv2d_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                   const T* __restrict__ bias, T* __restrict__ y,
                   const ConvArgs a) {
  extern __shared__ float4 smem4[];
  T* xs = reinterpret_cast<T*>(smem4);
  T* ws = xs + window_elems<T>(a);
  // elements a window copy: 16 bytes, or one element (bf16: a plain load)
  constexpr int kVx = kVecX ? 16 / (int)sizeof(T) : 1;

  const int cin_pg = a.cin / a.groups;
  const int cout_pg = a.cout / a.groups;
  const int s = a.stride, kh = a.kh, kw = a.kw;
  const int th = a.tile_h_out * s;            // fresh input rows per strip
  const int kc = kh > s ? kh - s : 0;         // rows carried to the next strip
  const int wc = window_cols(a);
  const int row_len = wc * a.cin_stride;      // elements per ring slot
  const int tcp = 4 * a.tcx;                  // weight row pitch
  const bool prefetch = a.ring_rows >= 2 * th + kc;

  int b = blockIdx.x;
  const int band = b % a.n_bands; b /= a.n_bands;
  const int cot = b % a.co_tiles; b /= a.co_tiles;
  const int grp = b % a.groups;
  const int img = b / a.groups;
  const int t_first = blockIdx.y * a.strips_per_seg;
  const int t_last = min(t_first + a.strips_per_seg, a.n_strips);

  const int tid = threadIdx.x;
  const int tx = tid % a.tcx;
  const int ty = tid / a.tcx;
  const int pthreads = kThreads / a.tcx;
  const bool computes = ty < pthreads;
  const int positions = a.tile_h_out * a.tile_w;
  const int col0 = band * a.tile_w * s - a.pad_left;
  const T* xin = x + (size_t)img * a.h * a.w * a.cin + grp * cin_pg;
  const int co_base = grp * cout_pg + cot * a.tile_cout;
  const int co_valid = min(a.tile_cout, cout_pg - cot * a.tile_cout);
  const int cin_chunks = (cin_pg + kChunk - 1) / kChunk;
  const int n_chunks = kh * kw * cin_chunks;  // weight stages per strip

  // Copies part `part` of `parts` of padded rows [r0, r0 + rows) of the
  // band into their ring slots (zeros outside the image).
  const int units = wc * (cin_pg / kVx);      // copies per row
  auto copy_rows = [&](int r0, int rows, int part, int parts) {
    const int total = rows * units;
    const int per = (total + parts - 1) / parts;
    const int end = min(total, (part + 1) * per);
    for (int idx = part * per + tid; idx < end; idx += kThreads) {
      const int r = idx / units;
      const int rem = idx - r * units;
      const int c = rem / (cin_pg / kVx);
      const int ci = (rem - c * (cin_pg / kVx)) * kVx;
      const int ih = r0 + r - a.pad_top;
      const int iw = col0 + c;
      const bool in = ih >= 0 && ih < a.h && iw >= 0 && iw < a.w;
      const T* src = in ? xin + ((size_t)ih * a.w + iw) * a.cin + ci : xin;
      T* dst = xs + ((r0 + r) % a.ring_rows) * row_len +
               c * a.cin_stride + ci;
      if constexpr (kVecX)
        cp_async16(reinterpret_cast<float*>(dst),
                   reinterpret_cast<const float*>(src), in);
      else if constexpr (sizeof(T) == 4)
        cp_async4(reinterpret_cast<float*>(dst),
                  reinterpret_cast<const float*>(src), in);
      else  // no 2-byte cp.async: a plain load, seen after the barrier
        *dst = in ? *src : T(0.0f);
    }
  };

  // Weight stage: input channels [ci0, ci0 + 16) of one tap x the tile's
  // C_out (zeros past the tile's valid channels).
  auto copy_weights = [&](int chunk, int stage) {
    const int tap = chunk / cin_chunks;
    const int ci0 = (chunk - tap * cin_chunks) * kChunk;
    const int nc = min(kChunk, cin_pg - ci0);
    const T* src0 = wt + ((size_t)tap * cin_pg + ci0) * a.cout + co_base;
    T* dst0 = ws + stage * kChunk * tcp;
    if (a.vec_w) {  // 4 output channels a copy: 16 bytes of f32, 8 of bf16
      const int per_row = tcp / 4;
      for (int idx = tid; idx < nc * per_row; idx += kThreads) {
        const int cc = idx / per_row, co = (idx - cc * per_row) * 4;
        const bool ok = co < co_valid;
        const T* src = ok ? src0 + (size_t)cc * a.cout + co : wt;
        if constexpr (sizeof(T) == 4)
          cp_async16(reinterpret_cast<float*>(dst0 + cc * tcp + co),
                     reinterpret_cast<const float*>(src), ok);
        else
          cp_async8(dst0 + cc * tcp + co, src, ok);
      }
    } else {
      for (int idx = tid; idx < nc * tcp; idx += kThreads) {
        const int cc = idx / tcp, co = idx - cc * tcp;
        const bool ok = co < co_valid;
        const T* src = ok ? src0 + (size_t)cc * a.cout + co : wt;
        if constexpr (sizeof(T) == 4)
          cp_async4(reinterpret_cast<float*>(dst0 + cc * tcp + co),
                    reinterpret_cast<const float*>(src), ok);
        else
          dst0[cc * tcp + co] = ok ? *src : T(0.0f);
      }
    }
  };

  // the first window whole, with the first weight stage
  copy_rows(t_first * th, th + kc, 0, 1);
  copy_weights(0, 0);
  cp_async_commit();
  int stage = 0;

  for (int t = t_first; t < t_last; ++t) {
    const bool has_next = t + 1 < t_last;
    if (t > t_first && !prefetch) {
      // the fresh rows replace strip t-1's first TH rows: every thread is
      // done with strip t-1
      __syncthreads();
      copy_rows(t * th + kc, th, 0, 1);
      cp_async_commit();
    }

    float acc[kPositions][kCout];
#pragma unroll
    for (int m = 0; m < kPositions; ++m)
#pragma unroll
      for (int j = 0; j < kCout; ++j) acc[m][j] = 0.0f;
    int off[kPositions];

    for (int c = 0; c < n_chunks; ++c) {
      cp_async_wait<0>();    // this thread's copies of stage c have landed
      __syncthreads();       // everyone's; and stage c-1 is consumed
      if (c + 1 < n_chunks || has_next)
        copy_weights((c + 1) % n_chunks, stage ^ 1);
      if (prefetch && has_next) copy_rows((t + 1) * th + kc, th, c, n_chunks);
      cp_async_commit();

      const int tap = c / cin_chunks;
      const int ci0 = (c - tap * cin_chunks) * kChunk;
      if (ci0 == 0) {        // a new tap: the positions' window offsets
        const int ki = tap / kw, kj = tap - ki * kw;
#pragma unroll
        for (int m = 0; m < kPositions; ++m) {
          const int p = ty + m * pthreads;
          int o = 0;  // idle slots read a valid address, never stored
          if (p < positions) {
            const int i = p / a.tile_w, cc = p - i * a.tile_w;
            const int slot = (t * th + i * s + ki) % a.ring_rows;
            o = (slot * wc + cc * s + kj) * a.cin_stride;
          }
          off[m] = o;
        }
      }
      if (computes) {
        const int nc = min(kChunk, cin_pg - ci0);
        const T* wsb = ws + stage * kChunk * tcp + 4 * tx;
        const T* xsb = xs + ci0;
        if (kVecX) {
          // 4 input channels: 8 window float4s, 4 weight float4s, 128 FMAs
          auto mac4 = [&](int cc) {
            float4 xv[kPositions];
#pragma unroll
            for (int m = 0; m < kPositions; ++m)
              xv[m] = load4(xsb + off[m] + cc);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float4 wv = load4(wsb + (cc + u) * tcp);
#pragma unroll
              for (int m = 0; m < kPositions; ++m) {
                const float xu = u == 0   ? xv[m].x
                                 : u == 1 ? xv[m].y
                                 : u == 2 ? xv[m].z
                                          : xv[m].w;
                acc[m][0] = fmaf(xu, wv.x, acc[m][0]);
                acc[m][1] = fmaf(xu, wv.y, acc[m][1]);
                acc[m][2] = fmaf(xu, wv.z, acc[m][2]);
                acc[m][3] = fmaf(xu, wv.w, acc[m][3]);
              }
            }
          };
          if (nc == kChunk) {  // a full stage: unrolled, loads hoisted
#pragma unroll
            for (int cc = 0; cc < kChunk; cc += 4) mac4(cc);
          } else {
#pragma unroll 1
            for (int cc = 0; cc < nc; cc += 4) mac4(cc);
          }
        } else {
          for (int cc = 0; cc < nc; ++cc) {
            const float4 wv = load4(wsb + cc * tcp);
#pragma unroll
            for (int m = 0; m < kPositions; ++m) {
              const float xu = to_f32(xsb[off[m] + cc]);
              acc[m][0] = fmaf(xu, wv.x, acc[m][0]);
              acc[m][1] = fmaf(xu, wv.y, acc[m][1]);
              acc[m][2] = fmaf(xu, wv.z, acc[m][2]);
              acc[m][3] = fmaf(xu, wv.w, acc[m][3]);
            }
          }
        }
      }
      stage ^= 1;
    }

    if (!computes) continue;
#pragma unroll
    for (int m = 0; m < kPositions; ++m) {
      const int p = ty + m * pthreads;
      if (p >= positions) continue;
      const int i = p / a.tile_w, cc = p - i * a.tile_w;
      const int oh = t * a.tile_h_out + i, ow = band * a.tile_w + cc;
      if (oh >= a.h_out || ow >= a.w_out) continue;
      T* yrow = y + (((size_t)img * a.h_out + oh) * a.w_out + ow) * a.cout +
                co_base;
#pragma unroll
      for (int j = 0; j < kCout; ++j) {
        const int co = 4 * tx + j;
        if (co >= co_valid) continue;
        float v = acc[m][j];
        if (bias != nullptr) v = v + to_f32(bias[co_base + co]);
        store_elem(yrow + co, activate(v, a.activation));
      }
    }
  }
}

template <typename T, bool kVecX, int kMinBlocks>
int launch_kernel(const T* x, const T* w, const T* bias, T* y,
                  const ConvArgs& a, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      trim_conv2d_kernel<T, kVecX, kMinBlocks>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.n * a.groups * a.co_tiles * a.n_bands, a.segments);
  trim_conv2d_kernel<T, kVecX, kMinBlocks>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          x, w, bias, y, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* x, const T* w, const T* bias, T* y, ConvArgs a,
           void* stream) {
  if (a.kh < 1 || a.kw < 1 || a.stride < 1 || a.groups < 1 ||
      a.cin % a.groups != 0 || a.cout % a.groups != 0 || a.tile_cout < 1 ||
      a.tile_cout > 32 * kCout ||
      a.tile_h_out < 1 || a.tile_w < 1 || a.strips_per_seg < 1)
    return (int)cudaErrorInvalidValue;
  const int cin_pg = a.cin / a.groups, cout_pg = a.cout / a.groups;
  const int kc = a.kh > a.stride ? a.kh - a.stride : 0;
  a.tcx = (a.tile_cout + kCout - 1) / kCout;
  a.n_strips = (a.h_out + a.tile_h_out - 1) / a.tile_h_out;
  a.n_bands = (a.w_out + a.tile_w - 1) / a.tile_w;
  a.co_tiles = (cout_pg + a.tile_cout - 1) / a.tile_cout;
  a.segments = (a.n_strips + a.strips_per_seg - 1) / a.strips_per_seg;
  // 16-byte window copies: 4 f32 or 8 bf16 channels
  constexpr int kVx = 16 / (int)sizeof(T);
  const bool vec_x = cin_pg % kVx == 0 && a.cin_stride % kVx == 0 &&
                     (uintptr_t)x % 16 == 0;
  a.vec_w = a.cout % 4 == 0 && cout_pg % 4 == 0 && a.tile_cout % 4 == 0 &&
            (uintptr_t)w % (4 * sizeof(T)) == 0;
  if (a.tile_h_out * a.tile_w > (kThreads / a.tcx) * kPositions ||
      a.cin_stride < cin_pg || a.ring_rows < a.tile_h_out * a.stride + kc ||
      a.segments > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(a);
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  // a window too large for two blocks an SM runs the instance that may
  // use all 255 registers (deeper load pipelining, one block an SM)
  const bool one = 2 * (smem + kReservedSmem) > (size_t)kSmemPerSm;
  if (vec_x)
    return one ? launch_kernel<T, true, 1>(x, w, bias, y, a, smem, stream)
               : launch_kernel<T, true, 2>(x, w, bias, y, a, smem, stream);
  return one ? launch_kernel<T, false, 1>(x, w, bias, y, a, smem, stream)
             : launch_kernel<T, false, 2>(x, w, bias, y, a, smem, stream);
}

// ---------------------------------------------------------------------------
// bf16, route mma: an implicit GEMM on the bf16 tensor cores
// ---------------------------------------------------------------------------

// The route of a bf16 layer (core/conv_plan.py, bf16_route).
inline int bf16_route_of(int cin_pg) {
  return cin_pg % kBf16MmaK == 0 ? kRouteMma : kRouteFfma;
}

// Window columns of one stride phase; the window is stored phase-split.
__host__ __device__ inline int phase_cols(const ConvArgs& a) {
  return (window_cols(a) + a.stride - 1) / a.stride;
}

// Elements of one ring row: the phase-split columns plus the fewest
// 16-byte quads that make the next output row (stride ring rows on)
// continue the bank-quad sequence of this one, so an ldmatrix phase that
// crosses output rows stays conflict free (none where the stride and band
// make that impossible).
__host__ __device__ inline int mma_row_elems(const ConvArgs& a) {
  const int cols = a.stride * phase_cols(a) * a.cin_stride;
  const int quads = a.cin_stride / 8;
  for (int d = 0; d < 8; ++d)
    if ((a.stride * (cols / 8 + d) - a.tile_w * quads) % 8 == 0)
      return cols + 8 * d;
  return cols;
}

// Elements of the window ring, rounded to 16 bytes so the next region
// aligns.
__host__ __device__ inline int mma_window_elems(const ConvArgs& a) {
  return (a.ring_rows * mma_row_elems(a) + 7) / 8 * 8;
}

// Elements of a weight-ring row and stage.
__host__ __device__ inline int mma_wpitch(const ConvArgs& a) {
  return kBf16WarpN * a.warps_n + kBf16RowPad;
}
__host__ __device__ inline int mma_stage_elems(const ConvArgs& a) {
  return kMmaStageSteps * kBf16MmaK * mma_wpitch(a);
}

inline size_t mma_smem_bytes(const ConvArgs& a) {
  return 2 * ((size_t)mma_window_elems(a) +
              (size_t)kMmaStages * mma_stage_elems(a) +
              (size_t)kWarps * kBf16MmaM * kMmaStagingPitch);
}

// kMF: the instance's m16 fragments a warp (m_frags <= kMF).
template <int kMF, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
trim_conv2d_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ wt,
                       const __nv_bfloat16* __restrict__ bias,
                       __nv_bfloat16* __restrict__ y, const ConvArgs a) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 smem4[];
  bf16* const xs = reinterpret_cast<bf16*>(smem4);
  bf16* const ws = xs + mma_window_elems(a);
  const int wp = mma_wpitch(a), stage_elems = mma_stage_elems(a);
  bf16* const stg = ws + kMmaStages * stage_elems;

  const int cin_pg = a.cin / a.groups;
  const int cout_pg = a.cout / a.groups;
  const int s = a.stride, kh = a.kh, kw = a.kw;
  const int th = a.tile_h_out * s;            // fresh input rows per strip
  const int kc = kh > s ? kh - s : 0;         // rows carried to the next strip
  const int wc = window_cols(a);
  const int pc = phase_cols(a);
  const int row_len = mma_row_elems(a);       // elements per ring slot
  const int positions = a.tile_h_out * a.tile_w;
  const int k_rows = kh * kw * cin_pg;        // rows of the (ki, kj, ci) axis
  const int n_blk = kBf16WarpN * a.warps_n;   // weight columns of a stage
  const int n_st = a.n_st;

  int b = blockIdx.x;
  const int band = b % a.n_bands; b /= a.n_bands;
  const int cot = b % a.co_tiles; b /= a.co_tiles;
  const int grp = b % a.groups;
  const int img = b / a.groups;
  const int t_first = blockIdx.y * a.strips_per_seg;
  const int t_last = min(t_first + a.strips_per_seg, a.n_strips);
  const int col0 = band * a.tile_w * s - a.pad_left;
  const bf16* xin = x + (size_t)img * a.h * a.w * a.cin + grp * cin_pg;
  const int co_base = grp * cout_pg + cot * a.tile_cout;
  const int co_valid = min(a.tile_cout, cout_pg - cot * a.tile_cout);
  const int total_st = (t_last - t_first) * n_st;  // the segment's stages
  // the next strip's rows ride on the first stages' commits; where a strip
  // has too few stages for them to land by the next strip's first wait,
  // that wait drains every copy
  const bool prefetch = a.ring_rows >= 2 * th + kc;
  const int pf_parts = max(1, n_st - kMmaStages + 2);
  const bool drain = !prefetch || n_st - kMmaStages + 2 < 1;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wn = warp % a.warps_n, wm = warp / a.warps_n;
  const int g = lane / 4, tq = lane % 4;      // fragment row / column pair

  // Copies part `part` of `parts` of padded rows [r0, r0 + rows) of the
  // band into their ring slots, columns phase-split; zeros outside the
  // image.  8 channels a 16-byte cp.async, or (x not 16-byte aligned) one
  // element a plain load, seen after the barrier.
  auto copy_rows = [&](int r0, int rows, int part, int parts) {
    const int vx = a.vec_x ? 8 : 1;
    const int per_col = cin_pg / vx;
    const int units = wc * per_col;
    const int total = rows * units;
    const int per = (total + parts - 1) / parts;
    const int end = min(total, (part + 1) * per);
    for (int idx = part * per + tid; idx < end; idx += kThreads) {
      const int r = idx / units;
      const int rem = idx - r * units;
      const int c = rem / per_col;
      const int ci = (rem - c * per_col) * vx;
      const int ih = r0 + r - a.pad_top;
      const int iw = col0 + c;
      const bool in = ih >= 0 && ih < a.h && iw >= 0 && iw < a.w;
      const bf16* src = in ? xin + ((size_t)ih * a.w + iw) * a.cin + ci : xin;
      bf16* dst = xs + ((r0 + r) % a.ring_rows) * row_len +
                  ((c % s) * pc + c / s) * a.cin_stride + ci;
      if (a.vec_x)
        cp_async16(reinterpret_cast<float*>(dst),
                   reinterpret_cast<const float*>(src), in);
      else
        *dst = in ? *src : __float2bfloat16_rn(0.0f);
    }
  };

  // Weight stage gs of the segment: rows [64 ls, 64 ls + 64) of the
  // (ki, kj, ci) x C_out matrix, ls = gs mod n_st, at the tile's n_blk
  // columns (zeros past its valid channels).  8 channels a 16-byte
  // cp.async, or one element a plain load.
  auto issue = [&](int gs) {
    if (gs >= total_st) return;
    const int r0 = (gs % n_st) * kMmaStageSteps * kBf16MmaK;
    const int nr = min(kMmaStageSteps * kBf16MmaK, k_rows - r0);
    const bf16* src0 = wt + (size_t)r0 * a.cout + co_base;
    bf16* dst0 = ws + (gs % kMmaStages) * stage_elems;
    if (a.vec_w) {
      const int per_row = n_blk / 8;
      for (int idx = tid; idx < nr * per_row; idx += kThreads) {
        const int r = idx / per_row, c = (idx - r * per_row) * 8;
        const bool ok = c < co_valid;
        const bf16* src = ok ? src0 + (size_t)r * a.cout + c : wt;
        cp_async16(reinterpret_cast<float*>(dst0 + r * wp + c),
                   reinterpret_cast<const float*>(src), ok);
      }
    } else {
      for (int idx = tid; idx < nr * n_blk; idx += kThreads) {
        const int r = idx / n_blk, c = idx - r * n_blk;
        dst0[r * wp + c] = c < co_valid ? src0[(size_t)r * a.cout + c]
                                        : __float2bfloat16_rn(0.0f);
      }
    }
  };

  // this lane's ldmatrix rows.  B: k row (lane & 7) + 8 ((lane >> 3) & 1)
  // of the k-step, channels 8 (lane >> 4) on of the warp's two n8 pairs;
  // A: its position in each m fragment (clamped to a valid one; such rows
  // are never stored), channels 8 (lane >> 4) on
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * wp +
                    wn * kBf16WarpN + (lane >> 4) * 8;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_half = (lane >> 4) * 8;
  auto a_pos = [&](int i) {
    return min((wm * a.m_frags + i) * kBf16MmaM + a_row, positions - 1);
  };
  int a_col[kMF];                              // its output column
#pragma unroll
  for (int i = 0; i < kMF; ++i) a_col[i] = a_pos(i) % a.tile_w;

  // the bias of this lane's channels: wn 32 + 8 j + 2 tq + e
  float bq[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = wn * kBf16WarpN + j * kBf16MmaN + 2 * tq + e;
      bq[j][e] = bias != nullptr && co < co_valid
                     ? to_f32(bias[co_base + co]) : 0.0f;
    }

  // the first window whole, with the first weight stages
  copy_rows(t_first * th, th + kc, 0, 1);
  issue(0);
  cp_async_commit();
#pragma unroll
  for (int i = 1; i < kMmaStages - 1; ++i) {
    issue(i);
    cp_async_commit();
  }

  bf16* const my_stg = stg + warp * kBf16MmaM * kMmaStagingPitch;
  int gs = 0;                                  // the segment's stage index
  for (int t = t_first; t < t_last; ++t) {
    const bool has_next = t + 1 < t_last;
    if (t > t_first && !prefetch) {
      // the fresh rows replace strip t-1's first TH rows: every thread is
      // done with strip t-1
      __syncthreads();
      copy_rows(t * th + kc, th, 0, 1);
      cp_async_commit();
    }

    float acc[kMF][4][4];
#pragma unroll
    for (int i = 0; i < kMF; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

    // this strip's ring row of each fragment's position at ki = 0, and the
    // k cursor: tap (ki, kj = qt s + ph), channels ci0..; a_off holds the
    // rows' window elements at the tap
    int rbase[kMF], a_off[kMF];
#pragma unroll
    for (int i = 0; i < kMF; ++i)
      rbase[i] = (t * th + a_pos(i) / a.tile_w * s) % a.ring_rows;
    KStep ks = {0, 0, 0};
    auto tap_offsets = [&]() {
      const int colk = (ks.kj % s) * pc + ks.kj / s;
#pragma unroll
      for (int i = 0; i < kMF; ++i) {
        int slot = rbase[i] + ks.ki;
        if (slot >= a.ring_rows) slot -= a.ring_rows;
        a_off[i] = slot * row_len + (a_col[i] + colk) * a.cin_stride +
                   a_half;
      }
    };
    tap_offsets();

    for (int st = 0; st < n_st; ++st, ++gs) {
      if (st == 0 && t > t_first && drain)
        cp_async_wait<0>();            // the fresh rows, committed last
      else
        cp_async_wait<kMmaStages - 2>();  // stage gs (and the rows) landed
      __syncthreads();                 // everyone's; stage gs-1 consumed
      issue(gs + kMmaStages - 1);      // into the buffer stage gs-1 freed
      if (prefetch && has_next && st < pf_parts)
        copy_rows((t + 1) * th + kc, th, st, pf_parts);
      cp_async_commit();

      // this stage's k-steps, in the contract's order (bf16_mma.cuh)
      const bf16* wsb = ws + (gs % kMmaStages) * stage_elems + b_off;
      auto load = [&](int q, uint32_t (&af)[kMF][4], uint32_t (&bf)[4][2]) {
        const bf16* bq0 = wsb + q * kBf16MmaK * wp;
        ldsm_x4_trans(bq0, bf[0], bf[1]);
        ldsm_x4_trans(bq0 + 2 * kBf16MmaN, bf[2], bf[3]);
#pragma unroll
        for (int i = 0; i < kMF; ++i)
          if (i < a.m_frags) ldsm_x4(xs + a_off[i] + ks.ci0, af[i]);
        if (ks.next(cin_pg, kw)) tap_offsets();
      };
      bf16_mma_steps<kMmaStageSteps>(
          acc, a.m_frags, min(kMmaStageSteps, a.k_steps - st * kMmaStageSteps),
          load);
    }

    // epilogue: + bias, activate(), one rounding on the C fragments; a
    // warp's m16 x 32 through its staging, then 16-byte stores, 8 channels
    // a lane, two rows of 4 lanes an iteration
#pragma unroll
    for (int i = 0; i < kMF; ++i) {
      if (i >= a.m_frags) break;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
          if (bias != nullptr) {
            v0 = v0 + bq[j][0];
            v1 = v1 + bq[j][1];
          }
          *reinterpret_cast<__nv_bfloat162*>(
              my_stg + (g + 8 * h) * kMmaStagingPitch + j * kBf16MmaN +
              2 * tq) =
              __halves2bfloat162(__float2bfloat16_rn(activate(v0,
                                                              a.activation)),
                                 __float2bfloat16_rn(activate(v1,
                                                              a.activation)));
        }
      __syncwarp();
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int row = it * 8 + lane / 4, c8 = (lane % 4) * 8;
        const int p = (wm * a.m_frags + i) * kBf16MmaM + row;
        const int oi = p / a.tile_w, oc = p - oi * a.tile_w;
        const int oh = t * a.tile_h_out + oi, ow = band * a.tile_w + oc;
        const int co = wn * kBf16WarpN + c8;
        if (p < positions && oh < a.h_out && ow < a.w_out && co < co_valid) {
          bf16* dst = y + (((size_t)img * a.h_out + oh) * a.w_out + ow) *
                              a.cout + co_base + co;
          const bf16* src = my_stg + row * kMmaStagingPitch + c8;
          if (a.vec_y && co + 8 <= co_valid)
            *reinterpret_cast<uint4*>(dst) =
                *reinterpret_cast<const uint4*>(src);
          else
            for (int e = 0; e < 8 && co + e < co_valid; ++e) dst[e] = src[e];
        }
      }
      __syncwarp();
    }
  }
}

template <int kMF, int kMinBlocks>
int launch_mma(const __nv_bfloat16* x, const __nv_bfloat16* w,
               const __nv_bfloat16* bias, __nv_bfloat16* y,
               const ConvArgs& a, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      trim_conv2d_mma_kernel<kMF, kMinBlocks>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.n * a.groups * a.co_tiles * a.n_bands, a.segments);
  trim_conv2d_mma_kernel<kMF, kMinBlocks>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          x, w, bias, y, a);
  return (int)cudaGetLastError();
}

// The bf16 entries: the plan's route, checked against Cin/g; route ffma
// launches the f32 kernel's template on bf16 as it did, route mma the
// tensor-core kernel.
int launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                const __nv_bfloat16* bias, __nv_bfloat16* y, ConvArgs a,
                void* stream) {
  if (a.kh < 1 || a.kw < 1 || a.stride < 1 || a.groups < 1 ||
      a.cin % a.groups != 0 || a.cout % a.groups != 0 || a.tile_cout < 1 ||
      a.tile_h_out < 1 || a.tile_w < 1 || a.strips_per_seg < 1)
    return (int)cudaErrorInvalidValue;
  const int cin_pg = a.cin / a.groups, cout_pg = a.cout / a.groups;
  if (a.route != bf16_route_of(cin_pg)) return (int)cudaErrorInvalidValue;
  if (a.route == kRouteFfma) {
    if (a.warps_n != 0 || a.m_frags != 0) return (int)cudaErrorInvalidValue;
    return launch(x, w, bias, y, a, stream);
  }
  const bool wn_ok = a.warps_n == 1 || a.warps_n == 2 || a.warps_n == 4;
  if (!wn_ok || a.m_frags < 1 || a.m_frags > kMmaMaxMFrags ||
      a.tile_cout > kBf16WarpN * a.warps_n)
    return (int)cudaErrorInvalidValue;
  const int kc = a.kh > a.stride ? a.kh - a.stride : 0;
  a.n_strips = (a.h_out + a.tile_h_out - 1) / a.tile_h_out;
  a.n_bands = (a.w_out + a.tile_w - 1) / a.tile_w;
  a.co_tiles = (cout_pg + a.tile_cout - 1) / a.tile_cout;
  a.segments = (a.n_strips + a.strips_per_seg - 1) / a.strips_per_seg;
  const int slots = kBf16MmaM * a.m_frags * (kWarps / a.warps_n);
  if (a.tile_h_out * a.tile_w > slots || a.cin_stride < cin_pg ||
      a.cin_stride % 8 != 0 || a.ring_rows < a.tile_h_out * a.stride + kc ||
      a.segments > 65535)
    return (int)cudaErrorInvalidValue;
  a.vec_x = (uintptr_t)x % 16 == 0;           // Cin % 16 == 0 on this route
  a.vec_w = a.cout % 8 == 0 && cout_pg % 8 == 0 && a.tile_cout % 8 == 0 &&
            (uintptr_t)w % 16 == 0;
  a.vec_y = a.cout % 8 == 0 && cout_pg % 8 == 0 && a.tile_cout % 8 == 0 &&
            (uintptr_t)y % 16 == 0;
  a.k_steps = a.kh * a.kw * cin_pg / kBf16MmaK;
  a.n_st = (a.k_steps + kMmaStageSteps - 1) / kMmaStageSteps;
  const size_t smem = mma_smem_bytes(a);
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  // a block too large for two an SM runs an instance compiled for one (the
  // plan counts resident blocks the same way); more than kMmaMFragsTwo m16
  // fragments a warp need more than 128 registers: one block an SM too
  const bool one = 2 * (smem + kReservedSmem) > (size_t)kSmemPerSm;
  if (a.m_frags > kMmaMFragsTwo)
    return launch_mma<kMmaMaxMFrags, 1>(x, w, bias, y, a, smem, stream);
  return one ? launch_mma<kMmaMFragsTwo, 1>(x, w, bias, y, a, smem, stream)
             : launch_mma<kMmaMFragsTwo, 2>(x, w, bias, y, a, smem, stream);
}

ConvArgs make_args(int n, int h, int w, int cin, int cout, int kh, int kw,
                   int stride, int pad_top, int pad_left, int groups,
                   int h_out, int w_out, int tile_h_out, int tile_w,
                   int tile_cout, int strips_per_seg, int ring_rows,
                   int cin_stride, int activation) {
  ConvArgs a = {};
  a.n = n; a.h = h; a.w = w; a.cin = cin; a.cout = cout; a.kh = kh; a.kw = kw;
  a.stride = stride; a.pad_top = pad_top; a.pad_left = pad_left;
  a.groups = groups; a.h_out = h_out; a.w_out = w_out;
  a.tile_h_out = tile_h_out; a.tile_w = tile_w; a.tile_cout = tile_cout;
  a.strips_per_seg = strips_per_seg; a.ring_rows = ring_rows;
  a.cin_stride = cin_stride; a.activation = activation;
  return a;
}

}  // namespace

// C entry points, bound with ctypes by repro_torch/kernels/build.py.  Each
// launches on `stream` without synchronising and returns cudaGetLastError()
// (or cudaErrorInvalidValue for a geometry or route the kernel cannot
// take).  strips_per_seg and ring_rows are ConvPlan's (at dtype_bytes 4 for
// the f32 entries, 2 for the bf16 ones); halo takes one strip a segment and
// the plain window ring whatever it is given.  The bf16 entries also take
// the plan's route (0 ffma, 1 mma; refused unless it is Cin/g's) and, on
// route mma, its warps along C_out and m16 fragments a warp (0 on ffma).
extern "C" {

#define TRIM_CONV2D_ARGS(T)                                                   \
  const T *x, const T *w, const T *bias, T *y, int n, int h, int wd, int cin, \
      int cout, int kh, int kw, int stride, int pad_top, int pad_left,        \
      int groups, int h_out, int w_out, int tile_h_out, int tile_w,           \
      int tile_cout, int strips_per_seg, int ring_rows, int cin_stride,       \
      int activation

#define TRIM_CONV2D_CARRY_ARGS                                                \
  make_args(n, h, wd, cin, cout, kh, kw, stride, pad_top, pad_left, groups,   \
            h_out, w_out, tile_h_out, tile_w, tile_cout, strips_per_seg,      \
            ring_rows, cin_stride, activation)

#define TRIM_CONV2D_HALO_ARGS                                                 \
  make_args(n, h, wd, cin, cout, kh, kw, stride, pad_top, pad_left, groups,   \
            h_out, w_out, tile_h_out, tile_w, tile_cout, 1,                   \
            tile_h_out * stride + (kh > stride ? kh - stride : 0),            \
            cin_stride, activation)

int trim_conv2d_carry(TRIM_CONV2D_ARGS(float), void* stream) {
  return launch(x, w, bias, y, TRIM_CONV2D_CARRY_ARGS, stream);
}

int trim_conv2d_halo(TRIM_CONV2D_ARGS(float), void* stream) {
  return launch(x, w, bias, y, TRIM_CONV2D_HALO_ARGS, stream);
}

int trim_conv2d_carry_bf16(TRIM_CONV2D_ARGS(__nv_bfloat16), int route,
                           int warps_n, int m_frags, void* stream) {
  ConvArgs a = TRIM_CONV2D_CARRY_ARGS;
  a.route = route; a.warps_n = warps_n; a.m_frags = m_frags;
  return launch_bf16(x, w, bias, y, a, stream);
}

int trim_conv2d_halo_bf16(TRIM_CONV2D_ARGS(__nv_bfloat16), int route,
                          int warps_n, int m_frags, void* stream) {
  ConvArgs a = TRIM_CONV2D_HALO_ARGS;
  a.route = route; a.warps_n = warps_n; a.m_frags = m_frags;
  return launch_bf16(x, w, bias, y, a, stream);
}

const char* trim_conv2d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
