// 3D-TrIM convolution for NVIDIA Hopper (sm_90a), int8 route, hand-written
// CUDA.
//
// Replaces the int8 route (has_scale=True) of the TPU Pallas kernels of
// src/repro/kernels/trim_conv2d.py:
//   trim_conv2d_q8_carry -> _carry_kernel (:127), with _tap_matmuls' int32
//                           accumulator (:82-100) and _epilogue_store's
//                           dequant (:103-124), dataflow="carry"
//   trim_conv2d_q8_halo  -> _halo_kernel (:162), dataflow="halo"
// Both entries launch one templated kernel; as in trim_conv2d.cu, the two
// dataflows differ only in how many strips one block walks, and they are
// bitwise equal (an integer sum is exact in any order).
//
// Math.  acc[n,oh,ow,g*Cpg+co] = sum_{ki,kj,ci} xpad[n, oh*s+ki, ow*s+kj,
// g*Cin_pg+ci] * w[ki,kj,ci,g*Cpg+co] over int8 operands in an int32
// accumulator (exact), then
//   y = activate(__fmul_rn(__int2float_rn(acc + bias_q[co]), scale[co]))
// with bias_q (int32) and scale (f32) from ref.dequant_params: one exact
// int32 add, one rounded int -> f32 conversion and one rounded multiply,
// written with the _rn intrinsics so that nvcc cannot contract the multiply
// into the activation's arithmetic (gelu's v + c v^3) as an FMA.  The
// virtual 'same' padding reads the activation ZERO POINT, not 0 (the JAX
// path pre-pads with it, ops.py:750-755): the zero-point correction in
// bias_q assumes every tap of every output sees a quantized value.
//
// Operands.  x: (N, H, W, Cin) int8.  Weights in ops.quantize_conv2d_weights'
// kernel layout (kernels/trim_conv2d.py, pack_q8_weights): (K, K, Cin4/4,
// Cout) 32-bit words of four consecutive input channels of one output
// channel, Cin4 = Cin/g rounded up to 4, the extra channels zero.  Each
// word is one operand of __dp4a (four int8 x int8 products added to an
// int32), so a thread's 4 output channels of one channel quad are one
// 16-byte load.
//
// Geometry (core/conv_plan.py, ConvPlan with dtype_bytes=1): the f32
// kernel's.  A block owns (image, group, C_out tile, column band) and one
// segment of the band's strips; its window, a ring of padded input rows x
// window columns x cin_stride BYTES, lives in shared memory, and strip t+1
// reuses the K-s rows strip t holds (the shadow registers).  256 threads:
// tcx = ceil(tile_cout / 4) along C_out x 256 / tcx along positions, each
// with 8 positions x 4 channels of int32 accumulators.  Weights stream
// through a 2-stage ring of [64 input channels of one tap] x [tile_cout]
// bytes filled by cp.async, one barrier a stage.
//   * Cin/g a multiple of 16 (VGG-16 conv2-13): the window is copied with
//     16-byte cp.async (zero-point fill outside the image as plain stores)
//     at a pitch of Cin/g + 16 where that fits, and the inner step takes
//     16 channels: 8 window int4 loads and 4 weight int4 loads for 128
//     __dp4a (512 MACs).
//   * Otherwise (conv1's Cin 3, depthwise's Cin/g 1): the window holds
//     Cin4 channels a position, the extra ones zero, filled a word at a
//     time by plain loads; the inner step takes 4 channels: 8 window
//     words and 1 weight int4 for 32 __dp4a.  No scalar tail: the zero
//     weights of the extra channels add exactly 0.
//
// What bounds it on the H100.  The int8 function is bound by bytes on
// VGG-16 (int8 in, f32 out) against the tensor cores' 1,979 TOPS; this
// kernel runs on the integer pipes instead (__dp4a: 64 lanes an SM a clock
// x 4 MACs, ~130 TOPS at 1.98 GHz), so it sits far above that bound.
// Tensor cores (mma.sync s8.s8.s32, wgmma) are a later design.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;        // threads per block (CONV_THREADS)
constexpr int kPositions = 8;        // output positions a thread
constexpr int kCout = 4;             // output channels a thread
constexpr int kQuad = 4;             // input channels of one __dp4a word
constexpr int kVec = 16;             // input channels of one 16-byte load
constexpr int kChunk = 64;           // input channels of one tap a stage
constexpr int kStages = 2;           // weight ring stages
constexpr int kMaxSmemBytes = 232448;  // H100: 227 KB opt-in per block
constexpr int kSmemPerSm = 233472;     // H100: 228 KB an SM
constexpr int kReservedSmem = 1024;    // the runtime's share of each block

struct Q8Args {
  int n, h, w, cin, cout, k, stride, pad_top, pad_left, groups;
  int h_out, w_out;
  int tile_h_out;    // output rows per strip
  int tile_w;        // output columns per band
  int tile_cout;     // output channels per block
  int strips_per_seg;
  int ring_rows;     // window ring slots (>= TH + K-s)
  int cin_stride;    // window channel pitch in bytes (>= Cin4)
  int zero_point;    // the activation's quantized 0.0: the padding value
  int activation;    // activate()'s code (epilogue.cuh)
  int cin4;          // Cin/g rounded up to kQuad
  int n_strips, n_bands, co_tiles, segments;
  int tcx;           // threads along C_out: ceil(tile_cout / 4)
  int vec_w;         // 16-byte weight copies
  int word_x;        // window words loaded whole (Cin/g % 4 == 0)
};

__host__ __device__ inline int window_cols(const Q8Args& a) {
  return (a.tile_w - 1) * a.stride + a.k;
}

// Bytes of the window ring, rounded to 16 so the weight ring aligns.
__host__ __device__ inline int window_bytes(const Q8Args& a) {
  return (a.ring_rows * window_cols(a) * a.cin_stride + 15) / 16 * 16;
}

inline size_t smem_bytes(const Q8Args& a) {
  return (size_t)window_bytes(a) + (size_t)kStages * kChunk * kCout * a.tcx;
}

__device__ __forceinline__ int lane_of(const int4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

template <bool kVecX, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
trim_conv2d_q8_kernel(const int8_t* __restrict__ x,
                      const int* __restrict__ wq,
                      const int* __restrict__ bias,
                      const float* __restrict__ scale,
                      float* __restrict__ y, const Q8Args a) {
  extern __shared__ int4 smem4[];
  int8_t* xs = reinterpret_cast<int8_t*>(smem4);
  int* ws = reinterpret_cast<int*>(xs + window_bytes(a));

  const int cin_pg = a.cin / a.groups;
  const int cout_pg = a.cout / a.groups;
  const int q4 = a.cin4 / kQuad;              // weight words of one tap
  const int s = a.stride, k = a.k;
  const int th = a.tile_h_out * s;            // fresh input rows per strip
  const int kc = k > s ? k - s : 0;           // rows carried to the next strip
  const int wc = window_cols(a);
  const int row_len = wc * a.cin_stride;      // bytes per ring slot
  const int tcp = kCout * a.tcx;              // weight row pitch (words)
  constexpr int kStageWords = kChunk / kQuad; // weight rows of one stage
  const bool prefetch = a.ring_rows >= 2 * th + kc;
  const uint32_t zp4 = 0x01010101u * (uint32_t)(uint8_t)a.zero_point;

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
  const int8_t* xin = x + (size_t)img * a.h * a.w * a.cin + grp * cin_pg;
  const int co_base = grp * cout_pg + cot * a.tile_cout;
  const int co_valid = min(a.tile_cout, cout_pg - cot * a.tile_cout);
  const int cin_chunks = (a.cin4 + kChunk - 1) / kChunk;
  const int n_chunks = k * k * cin_chunks;    // weight stages per strip

  // Copies part `part` of `parts` of padded rows [r0, r0 + rows) of the
  // band into their ring slots; positions outside the image read the zero
  // point.  16-byte route: cp.async from the image, plain stores of the
  // zero point.  Word route: a word of 4 channels a copy, channels past
  // Cin/g zero.
  const int units = wc * (kVecX ? cin_pg / kVec : q4);  // copies per row
  auto copy_rows = [&](int r0, int rows, int part, int parts) {
    const int total = rows * units;
    const int per = (total + parts - 1) / parts;
    const int end = min(total, (part + 1) * per);
    for (int idx = part * per + tid; idx < end; idx += kThreads) {
      const int r = idx / units;
      const int rem = idx - r * units;
      const int c = rem / (units / wc);
      const int ci = (rem - c * (units / wc)) * (kVecX ? kVec : kQuad);
      const int ih = r0 + r - a.pad_top;
      const int iw = col0 + c;
      const bool in = ih >= 0 && ih < a.h && iw >= 0 && iw < a.w;
      const int8_t* src =
          in ? xin + ((size_t)ih * a.w + iw) * a.cin + ci : xin;
      int8_t* dst = xs + ((r0 + r) % a.ring_rows) * row_len +
                    c * a.cin_stride + ci;
      if (kVecX) {
        if (in)
          cp_async16(reinterpret_cast<float*>(dst),
                     reinterpret_cast<const float*>(src), true);
        else
          *reinterpret_cast<int4*>(dst) =
              make_int4((int)zp4, (int)zp4, (int)zp4, (int)zp4);
      } else {
        uint32_t v;
        if (!in) {
          v = zp4;
        } else if (a.word_x) {
          v = *reinterpret_cast<const uint32_t*>(src);
        } else {
          v = 0;
#pragma unroll
          for (int j = 0; j < kQuad; ++j)
            if (ci + j < cin_pg) v |= (uint32_t)(uint8_t)src[j] << (8 * j);
        }
        if (ci + kQuad > cin_pg) {   // channels past Cin/g: zero
          const int live = cin_pg - ci;
          v &= live >= kQuad ? 0xffffffffu : (1u << (8 * live)) - 1u;
        }
        *reinterpret_cast<uint32_t*>(dst) = v;
      }
    }
  };

  // Weight stage: channel words [q0, q0 + 16) of one tap x the tile's
  // C_out (zeros past the tile's valid channels).
  auto copy_weights = [&](int chunk, int stage) {
    const int tap = chunk / cin_chunks;
    const int q0 = (chunk - tap * cin_chunks) * kStageWords;
    const int nq = min(kStageWords, q4 - q0);
    const int* src0 = wq + ((size_t)tap * q4 + q0) * a.cout + co_base;
    int* dst0 = ws + stage * kStageWords * tcp;
    if (a.vec_w) {
      const int per_row = tcp / 4;
      for (int idx = tid; idx < nq * per_row; idx += kThreads) {
        const int qq = idx / per_row, co = (idx - qq * per_row) * 4;
        const bool ok = co < co_valid;
        cp_async16(reinterpret_cast<float*>(dst0 + qq * tcp + co),
                   reinterpret_cast<const float*>(
                       ok ? src0 + (size_t)qq * a.cout + co : wq), ok);
      }
    } else {
      for (int idx = tid; idx < nq * tcp; idx += kThreads) {
        const int qq = idx / tcp, co = idx - qq * tcp;
        const bool ok = co < co_valid;
        cp_async4(reinterpret_cast<float*>(dst0 + qq * tcp + co),
                  reinterpret_cast<const float*>(
                      ok ? src0 + (size_t)qq * a.cout + co : wq), ok);
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

    int acc[kPositions][kCout];
#pragma unroll
    for (int m = 0; m < kPositions; ++m)
#pragma unroll
      for (int j = 0; j < kCout; ++j) acc[m][j] = 0;
    int off[kPositions];

    for (int c = 0; c < n_chunks; ++c) {
      cp_async_wait<0>();    // this thread's copies of stage c have landed
      __syncthreads();       // everyone's; and stage c-1 is consumed
      if (c + 1 < n_chunks || has_next)
        copy_weights((c + 1) % n_chunks, stage ^ 1);
      if (prefetch && has_next) copy_rows((t + 1) * th + kc, th, c, n_chunks);
      cp_async_commit();

      const int tap = c / cin_chunks;
      const int q0 = (c - tap * cin_chunks) * kStageWords;
      if (q0 == 0) {         // a new tap: the positions' window offsets
        const int ki = tap / k, kj = tap - (tap / k) * k;
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
        const int nq = min(kStageWords, q4 - q0);
        const int* wsb = ws + stage * kStageWords * tcp + kCout * tx;
        const int8_t* xsb = xs + q0 * kQuad;
        if (kVecX) {
          // 16 channels: 8 window int4s, 4 weight int4s, 128 __dp4a
          auto mac16 = [&](int qq) {
            int4 xv[kPositions];
#pragma unroll
            for (int m = 0; m < kPositions; ++m)
              xv[m] = *reinterpret_cast<const int4*>(xsb + off[m] +
                                                     qq * kQuad);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int4 wv =
                  *reinterpret_cast<const int4*>(wsb + (qq + u) * tcp);
#pragma unroll
              for (int m = 0; m < kPositions; ++m) {
                const int xu = lane_of(xv[m], u);
                acc[m][0] = __dp4a(xu, wv.x, acc[m][0]);
                acc[m][1] = __dp4a(xu, wv.y, acc[m][1]);
                acc[m][2] = __dp4a(xu, wv.z, acc[m][2]);
                acc[m][3] = __dp4a(xu, wv.w, acc[m][3]);
              }
            }
          };
          if (nq == kStageWords) {  // a full stage: unrolled, loads hoisted
#pragma unroll
            for (int qq = 0; qq < kStageWords; qq += 4) mac16(qq);
          } else {
#pragma unroll 1
            for (int qq = 0; qq < nq; qq += 4) mac16(qq);
          }
        } else {
          for (int qq = 0; qq < nq; ++qq) {
            const int4 wv = *reinterpret_cast<const int4*>(wsb + qq * tcp);
#pragma unroll
            for (int m = 0; m < kPositions; ++m) {
              const int xu =
                  *reinterpret_cast<const int*>(xsb + off[m] + qq * kQuad);
              acc[m][0] = __dp4a(xu, wv.x, acc[m][0]);
              acc[m][1] = __dp4a(xu, wv.y, acc[m][1]);
              acc[m][2] = __dp4a(xu, wv.z, acc[m][2]);
              acc[m][3] = __dp4a(xu, wv.w, acc[m][3]);
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
      float* yrow = y + (((size_t)img * a.h_out + oh) * a.w_out + ow) * a.cout +
                    co_base;
#pragma unroll
      for (int j = 0; j < kCout; ++j) {
        const int co = kCout * tx + j;
        if (co >= co_valid) continue;
        int v = acc[m][j];
        if (bias != nullptr) v += bias[co_base + co];  // exact int32 add
        const float f = __fmul_rn(__int2float_rn(v), scale[co_base + co]);
        yrow[co] = activate(f, a.activation);
      }
    }
  }
}

template <bool kVecX, int kMinBlocks>
int launch_kernel(const int8_t* x, const int* w, const int* bias,
                  const float* scale, float* y, const Q8Args& a, size_t smem,
                  void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      trim_conv2d_q8_kernel<kVecX, kMinBlocks>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.n * a.groups * a.co_tiles * a.n_bands, a.segments);
  trim_conv2d_q8_kernel<kVecX, kMinBlocks><<<
      grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, scale, y, a);
  return (int)cudaGetLastError();
}

int launch(const int8_t* x, const int* w, const int* bias, const float* scale,
           float* y, Q8Args a, void* stream) {
  if (a.k < 1 || a.stride < 1 || a.groups < 1 || a.cin % a.groups != 0 ||
      a.cout % a.groups != 0 || a.tile_cout < 1 || a.tile_cout > 32 * kCout ||
      a.tile_h_out < 1 || a.tile_w < 1 || a.strips_per_seg < 1 ||
      a.zero_point < -128 || a.zero_point > 127 || (uintptr_t)w % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int cin_pg = a.cin / a.groups, cout_pg = a.cout / a.groups;
  const int kc = a.k > a.stride ? a.k - a.stride : 0;
  a.cin4 = (cin_pg + kQuad - 1) / kQuad * kQuad;
  a.tcx = (a.tile_cout + kCout - 1) / kCout;
  a.n_strips = (a.h_out + a.tile_h_out - 1) / a.tile_h_out;
  a.n_bands = (a.w_out + a.tile_w - 1) / a.tile_w;
  a.co_tiles = (cout_pg + a.tile_cout - 1) / a.tile_cout;
  a.segments = (a.n_strips + a.strips_per_seg - 1) / a.strips_per_seg;
  const bool vec_x = cin_pg % kVec == 0 && a.cin % kVec == 0 &&
                     a.cin_stride % kVec == 0 && (uintptr_t)x % 16 == 0;
  a.word_x = cin_pg % kQuad == 0 && a.cin % kQuad == 0 &&
             (uintptr_t)x % 4 == 0;
  a.vec_w = a.cout % 4 == 0 && cout_pg % 4 == 0 && a.tile_cout % 4 == 0 &&
            (uintptr_t)w % 16 == 0;
  if (a.tile_h_out * a.tile_w > (kThreads / a.tcx) * kPositions ||
      a.cin_stride < a.cin4 || a.cin_stride % kQuad != 0 ||
      a.ring_rows < a.tile_h_out * a.stride + kc || a.segments > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a);
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  // a window too large for two blocks an SM runs the instance compiled for
  // one block an SM (the plan counts resident blocks the same way)
  const bool one = 2 * (smem + kReservedSmem) > (size_t)kSmemPerSm;
  if (vec_x)
    return one ? launch_kernel<true, 1>(x, w, bias, scale, y, a, smem, stream)
               : launch_kernel<true, 2>(x, w, bias, scale, y, a, smem, stream);
  return one ? launch_kernel<false, 1>(x, w, bias, scale, y, a, smem, stream)
             : launch_kernel<false, 2>(x, w, bias, scale, y, a, smem, stream);
}

Q8Args make_args(int n, int h, int w, int cin, int cout, int k, int stride,
                 int pad_top, int pad_left, int groups, int h_out, int w_out,
                 int tile_h_out, int tile_w, int tile_cout, int strips_per_seg,
                 int ring_rows, int cin_stride, int zero_point,
                 int activation) {
  Q8Args a = {};
  a.n = n; a.h = h; a.w = w; a.cin = cin; a.cout = cout; a.k = k;
  a.stride = stride; a.pad_top = pad_top; a.pad_left = pad_left;
  a.groups = groups; a.h_out = h_out; a.w_out = w_out;
  a.tile_h_out = tile_h_out; a.tile_w = tile_w; a.tile_cout = tile_cout;
  a.strips_per_seg = strips_per_seg; a.ring_rows = ring_rows;
  a.cin_stride = cin_stride; a.zero_point = zero_point;
  a.activation = activation;
  return a;
}

}  // namespace

// C entry points, bound with ctypes by repro_torch/kernels/build.py.  Each
// launches on `stream` without synchronising and returns cudaGetLastError()
// (or cudaErrorInvalidValue for a geometry the kernel cannot take).  `w` is
// the packed weight layout above; `bias` may be null; strips_per_seg,
// ring_rows and cin_stride are ConvPlan's (dtype_bytes=1); halo takes one
// strip a segment and the plain window ring whatever it is given.
extern "C" {

#define TRIM_CONV2D_Q8_ARGS                                                   \
  const int8_t *x, const int *w, const int *bias, const float *scale,         \
      float *y, int n, int h, int wd, int cin, int cout, int k, int stride,   \
      int pad_top, int pad_left, int groups, int h_out, int w_out,            \
      int tile_h_out, int tile_w, int tile_cout, int strips_per_seg,          \
      int ring_rows, int cin_stride, int zero_point, int activation,          \
      void *stream

int trim_conv2d_q8_carry(TRIM_CONV2D_Q8_ARGS) {
  return launch(x, w, bias, scale, y,
                make_args(n, h, wd, cin, cout, k, stride, pad_top, pad_left,
                          groups, h_out, w_out, tile_h_out, tile_w, tile_cout,
                          strips_per_seg, ring_rows, cin_stride, zero_point,
                          activation),
                stream);
}

int trim_conv2d_q8_halo(TRIM_CONV2D_Q8_ARGS) {
  const int kc = k > stride ? k - stride : 0;
  return launch(x, w, bias, scale, y,
                make_args(n, h, wd, cin, cout, k, stride, pad_top, pad_left,
                          groups, h_out, w_out, tile_h_out, tile_w, tile_cout,
                          1, tile_h_out * stride + kc, cin_stride, zero_point,
                          activation),
                stream);
}

const char* trim_conv2d_q8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
