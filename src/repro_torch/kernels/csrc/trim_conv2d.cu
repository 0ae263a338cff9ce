// 3D-TrIM convolution for NVIDIA Hopper (sm_90a), f32 and bf16,
// hand-written CUDA.
//
// Replaces the TPU Pallas kernels of src/repro/kernels/trim_conv2d.py:
//   trim_conv2d_carry -> _carry_kernel (:127), with _tap_matmuls (:82) and
//                        _epilogue_store (:105), dataflow="carry"
//   trim_conv2d_halo  -> _halo_kernel (:162), dataflow="halo"
//   trim_conv2d_carry_bf16, trim_conv2d_halo_bf16 -> the same kernels on
//                        bf16 operands (their out dtype is the input's, :355)
// Every entry launches one templated kernel: the two dataflows differ only
// in how many strips one block walks (see Segments), the two element
// types only in what is stored (see bf16).
//
// Math.  y[n,oh,ow,g*Cpg+co] = act(bias + sum_{ki,kj,ci} xpad[n, oh*s+ki,
// ow*s+kj, g*Cin_pg+ci] * w[ki,kj,ci,g*Cpg+co]), ki < KH, kj < KW: a square
// kernel, or a rectangular sub-kernel of the kernel tiling (an 11 x 11
// kernel runs as 3x3, 3x2, 2x3 and 2x2 pieces, kernels/ops.py).  Every
// output element is ONE fp32 fmaf chain started from 0 and taken in a
// fixed order (ki, then kj, then ci ascending over all of Cin/g), then
// + bias (a separate add), then activate() of epilogue.cuh.  The order
// depends on nothing but the element, so carry and halo are bitwise
// equal, a row's result does not
// depend on the batch it was served in, and the fused kernel
// (trim_conv2d_fused.cu), which takes the same chain, equals a chain of
// these launches bit for bit.  No split of the sum across threads or
// blocks and no tensor cores (TF32 would change the chain): f32 FFMA.
//
// bf16.  The T = __nv_bfloat16 instance holds x, w, bias and y in bf16:
// the window ring and the weight ring are bf16 in shared memory (half the
// bytes, so the plan may take taller strips), each value widens to f32
// exactly on read (elem.cuh), and each output is the same single fmaf chain
// in (ki, kj, ci) order, + bias, activate(), then ONE __float2bfloat16_rn at
// the store.  A bf16 x bf16 product is exact in f32, so this is JAX's
// bf16 function (products exact, the sum in f32, one cast at the store),
// and carry == halo, batch invariance and fused == chain hold as in f32.
// The window's 16-byte copies carry 8 channels (Cin/g a multiple of 8, a
// pitch of Cin/g + 8); other rows (VGG-16's and AlexNet's Cin 3) load
// element by element, since cp.async copies no 2-byte unit.  Weights move
// as 8-byte copies of 4 output channels.  The bf16 tensor cores would
// change the order of every sum (ROADMAP Queue 2 C).
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
// Threads.  256 threads as tcx = ceil(tile_cout / 4) along C_out x
// 256 / tcx along positions; a thread holds kPositions = 8 output
// positions x kCout = 4 channels of fp32 accumulators (32), positions
// ty + m * (256 / tcx).  For each group of 4 input channels it issues 8
// float4 window loads (the lanes of a warp along C_out read the same
// positions: broadcasts; the window's channel pitch is Cin/g + 4 so that
// the 2-4 positions of a warp fall on different banks) and 4 float4
// weight loads, for 128 FMAs.
// Weights stream through a 2-stage ring of [16 input channels of one tap]
// x [tile_cout] filled by cp.async: stage c+1 lands while stage c
// computes, one barrier a stage.  Window rows also arrive by cp.async
// (16-byte copies where Cin/g is a multiple of 4, zero-filled padding).
// A window too large for two blocks an SM runs an instance compiled for
// one block, which may use more than 128 registers.
//
// What bounds it on the H100.  At VGG-16 shapes the conv does hundreds of
// FLOPs per byte it must move, so the bound is operations: 67 TFLOP/s of
// non-tensor f32.  The design aims at the FFMA pipes: 32 independent
// accumulator chains a thread, few shared-memory loads per FMA, copies off
// the critical path, and enough blocks to fill the SMs.  At Cin/g = 512 the
// window of an 8 x 8 strip (10 x 10 x 516 floats, 206 KB) takes the whole
// shared memory, so such layers run one block (8 warps) an SM.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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
// (or cudaErrorInvalidValue for a geometry the kernel cannot take).
// strips_per_seg and ring_rows are ConvPlan's (at dtype_bytes 4 for the f32
// entries, 2 for the bf16 ones); halo takes one strip a segment and the
// plain window ring whatever it is given.
extern "C" {

#define TRIM_CONV2D_ARGS(T)                                                   \
  const T *x, const T *w, const T *bias, T *y, int n, int h, int wd, int cin, \
      int cout, int kh, int kw, int stride, int pad_top, int pad_left,        \
      int groups, int h_out, int w_out, int tile_h_out, int tile_w,           \
      int tile_cout, int strips_per_seg, int ring_rows, int cin_stride,       \
      int activation, void *stream

#define TRIM_CONV2D_CARRY                                                     \
  launch(x, w, bias, y,                                                       \
         make_args(n, h, wd, cin, cout, kh, kw, stride, pad_top, pad_left,    \
                   groups, h_out, w_out, tile_h_out, tile_w, tile_cout,       \
                   strips_per_seg, ring_rows, cin_stride, activation),        \
         stream)

#define TRIM_CONV2D_HALO                                                      \
  launch(x, w, bias, y,                                                       \
         make_args(n, h, wd, cin, cout, kh, kw, stride, pad_top, pad_left,    \
                   groups, h_out, w_out, tile_h_out, tile_w, tile_cout, 1,    \
                   tile_h_out * stride + (kh > stride ? kh - stride : 0),     \
                   cin_stride, activation),                                   \
         stream)

int trim_conv2d_carry(TRIM_CONV2D_ARGS(float)) { return TRIM_CONV2D_CARRY; }

int trim_conv2d_halo(TRIM_CONV2D_ARGS(float)) { return TRIM_CONV2D_HALO; }

int trim_conv2d_carry_bf16(TRIM_CONV2D_ARGS(__nv_bfloat16)) {
  return TRIM_CONV2D_CARRY;
}

int trim_conv2d_halo_bf16(TRIM_CONV2D_ARGS(__nv_bfloat16)) {
  return TRIM_CONV2D_HALO;
}

const char* trim_conv2d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
