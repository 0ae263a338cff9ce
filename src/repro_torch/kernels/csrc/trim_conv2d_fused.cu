// Fused residency group for NVIDIA Hopper (sm_90a), f32 and bf16,
// hand-written CUDA.
//
// Replaces the TPU Pallas kernel _fused_kernel of
// src/repro/kernels/trim_conv2d_fused.py (:102, with _stage_conv :67 and
// _stage_pool :87): a chain conv -> [max-pool] -> conv ... runs in one launch
// and every interior activation stays on chip.  trim_conv2d_fused takes f32
// operands, trim_conv2d_fused_bf16 bf16 ones (one templated kernel).  The
// geometry comes from repro_torch/core/fuse_plan.py (FusedGroup); the
// wrapper is repro_torch/kernels/trim_conv2d_fused.py.
//
// Geometry.  One block owns (image, strip, band): a tile of strip_rows x
// band_cols pooled outputs of the LAST stage.  Each stage's ranges are affine
// in (strip, band) (FusedStage): stage i reads an in_rows x in_cols x cin
// tile of its input and produces a pool_rows x pool_cols x cout tile of its
// pooled output, which is stage i+1's input tile.  The TPU strip spans the
// full width in 16 MiB of VMEM; a block here has 227 KB, so tiles are cut in
// both directions and a stage's halo rows AND columns are computed by every
// tile that needs them.
//   * Stage 0's input window arrives by cp.async (16-byte copies where
//     cin % 4 == 0 and x is aligned); 'same' padding is virtual, zero-filled
//     by the copy, as in trim_conv2d.cu.
//   * Stage i's input tile lives in buffer i % 2 at a channel pitch of
//     cin + 4 where cin % 4 == 0 (float4 loads; the positions a warp reads
//     at once fall on different banks), else cin.  An interior stage writes
//     its pooled outputs into the other buffer at the next stage's pitch and
//     zeroes every row and column outside the stage's valid pooled extent:
//     those zeros are exactly the next conv's 'same' padding, and valid
//     outputs never read anything else (the JAX kernel's argument, on both
//     axes).  The last stage writes its valid pooled outputs to memory.
//   * Each stage computes all its C_out, C_out tile by C_out tile, in passes
//     over its pooled positions.  Threads: tcx = ceil(tile_cout / 4) along
//     C_out x 256 / tcx along positions; a thread holds kPositions conv
//     outputs (8 positions, or two 2x2 pool windows; one 3x3 window takes
//     the kPool3Positions instance) x kCout = 4 channels of accumulators, so
//     the max-pool runs in registers after the epilogue and no pre-pool
//     buffer exists.  A pass computes each slot's window offset once; a tap
//     adds a constant.
//   * Weights stream as (ki, kj, ci) rows through a 2-stage ring of
//     [kChunk rows] x [tile_cout] filled by cp.async, one barrier a ring
//     stage: the stage after lands while this one computes.  A small cin
//     packs several taps into one ring stage (VGG-16's conv1: 27 rows, one
//     stage).  A stage's ring stages run on across its passes and C_out
//     tiles, and a cursor stepped once a ring stage keeps integer divides
//     out of the path from the barrier to the first FMA.
//
// Order.  Every conv output element is ONE fmaf chain in (ki, kj, ci) order
// from 0.0f over exactly ci < cin, then + bias, then activate() of
// epilogue.cuh -- the same arithmetic as trim_conv2d.cu.  Max-pooling picks
// one of its inputs exactly.  So a fused group is bitwise equal to the
// per-layer carry chain (conv kernel, then a separate max-pool), and a
// served row to forward_one.  No TF32, no split of a sum across threads.
//
// bf16.  The T = __nv_bfloat16 instance keeps the input tile, the stage
// buffers and the weight ring in bf16, widens each value to f32 exactly on
// read (elem.cuh), and takes the same fmaf chain, + bias (bf16, widened:
// JAX casts the bias to the input dtype), activate(); each stage is rounded
// to bf16 once (__float2bfloat16_rn) where the JAX kernel casts it to the
// scratch dtype (:84), after the max over its pool window, which commutes
// with that monotone rounding.  So every stage is rounded exactly where the
// per-layer bf16 chain stores it, and fused == chain bitwise holds in bf16.
// Pitches and buffers are the f32 kernel's, in elements (fuse_plan's; the
// bytes halve), so a copy of 4 channels is 8 bytes: the stage-0 window and
// the weights move as 8-byte cp.async copies, VGG-16's conv1 (cin 3)
// element by element (cp.async copies no 2-byte unit).
//
// What bounds it on the H100.  At VGG-16's early layers the group does
// hundreds of FLOPs per byte it must move, so the bound is operations:
// 67 TFLOP/s of non-tensor f32.  Fusing cuts the bytes the per-layer chain
// moves (the interior ofmap and the pool's read and write never reach
// device memory) at the cost of the recomputed halo (1.01-1.14x FLOPs on the
// VGG-16 groups).  The inner loop is the per-layer kernel's: for each group
// of 4 input channels a thread issues kPositions float4 window loads (the
// lanes of a warp along C_out read the same positions: broadcasts) and 4
// float4 weight loads for 128 FMAs.  Buffers and ring take up to 227 KB, so
// a block runs alone on its SM (8 warps, up to 255 registers a thread).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "elem.cuh"
#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;          // threads per block
constexpr int kMaxStages = 8;          // stages of one launch
constexpr int kPositions = 8;          // conv outputs a thread (pool 1x1, 2x2)
constexpr int kPool3Positions = 9;     // conv outputs a thread (pool 3x3)
constexpr int kCout = 4;               // output channels a thread (a float4)
constexpr int kMaxTileCout = 32 * kCout;  // a warp along C_out
constexpr int kChunk = 32;             // (tap, channel) rows a ring stage
constexpr int kStages = 2;             // weight ring stages
constexpr int kMaxSmemBytes = 232448;  // H100: 227 KB opt-in per block
constexpr int kHeader = 9;             // ints before the per-stage fields
constexpr int kStageFields = 22;       // ints per stage (see make_args)

struct StageArgs {
  const void* w;   // (K, K, cin, cout), of the launch's element type
  const void* b;   // (cout,) or nullptr
  int cin, cout, k, stride, ps, pw, h_pool, w_pool;
  int in_rows, in_cols, pool_rows, pool_cols;
  int in_row_start, in_row_step, in_col_start, in_col_step;
  int pool_row_start, pool_row_step, pool_col_start, pool_col_step;
  int tile_cout, in_pitch;
  int tcx;         // threads along C_out: ceil(tile_cout / kCout)
  int per_thread;  // pooled positions a thread: whole windows of its slots
  int out_pitch;   // the next stage's in_pitch (unused by the last stage)
  int vec_w;       // weight copies of 4 channels (16 bytes f32, 8 bf16)
};

struct FusedArgs {
  int n, h, w, cin, depth, n_strips, n_bands;
  int buf0, buf1;   // elements of the ping-pong buffers (multiples of 4)
  int ring_cout;    // elements of one ring row: 4 x the widest stage's tcx
  int vec_x;        // stage-0 window copies of 4 channels (16 / 8 bytes)
  int activation;   // activate()'s code (epilogue.cuh)
  StageArgs st[kMaxStages];
};

// One stage of one tile: every C_out tile and pass, weights through the
// ring.  `in` holds the stage's input tile; `out` receives its pooled,
// masked output (or `y`, for the last stage).
template <typename T, int kSlots, bool kVec>
__device__ __forceinline__ void run_stage(const StageArgs& st, bool last,
                                          int act, const T* in, T* out, T* ws,
                                          int ring_cout, T* __restrict__ y,
                                          int img, int strip, int band) {
  const T* const wt = static_cast<const T*>(st.w);
  const T* const bias = static_cast<const T*>(st.b);
  const int tid = threadIdx.x;
  const int cin = st.cin, cout = st.cout, k = st.k, s = st.stride;
  const int ps = st.ps, pw = st.pw, pw2 = st.pw * st.pw;
  const int tcx = st.tcx, tcp = 4 * tcx, tile_cout = st.tile_cout;
  const int tx = tid % tcx, ty = tid / tcx;
  const int pthreads = kThreads / tcx;
  const bool computes = ty < pthreads;
  const int per_pass = pthreads * st.per_thread;
  const int positions = st.pool_rows * st.pool_cols;
  const int passes = (positions + per_pass - 1) / per_pass;
  const int co_tiles = (cout + tile_cout - 1) / tile_cout;
  const int pitch = st.in_pitch;
  const int gr0 = st.pool_row_start + strip * st.pool_row_step;
  const int gc0 = st.pool_col_start + band * st.pool_col_step;

  // The weights as rows (ki, kj, ci) x C_out: a ring stage holds kChunk
  // consecutive rows (within one tap where cin % kChunk == 0) of one C_out
  // tile.  A unit is one ring stage of one pass, with the tap and channel
  // of its first row; units run C_out tile by C_out tile, pass by pass.
  const int rows = k * k * cin;
  struct Unit { int cot, pass, r0, ki, kj, ci0; };
  auto next = [&](Unit& v) {
    v.r0 += kChunk;
    if (v.r0 >= rows) {
      v.r0 = v.ki = v.kj = v.ci0 = 0;
      if (++v.pass == passes) {
        v.pass = 0;
        ++v.cot;
      }
      return;
    }
    for (v.ci0 += kChunk; v.ci0 >= cin; v.ci0 -= cin)
      if (++v.kj == k) {
        v.kj = 0;
        ++v.ki;
      }
  };
  // this thread's 16-byte copies of a full ring stage: rows and columns
  constexpr int kCopies =
      (kChunk * kMaxTileCout / 4 + kThreads - 1) / kThreads;
  int copy_cc[kCopies], copy_co[kCopies];
#pragma unroll
  for (int it = 0; it < kCopies; ++it) {
    const int idx = tid + it * kThreads;
    copy_cc[it] = idx / tcx;
    copy_co[it] = (idx - copy_cc[it] * tcx) * 4;
  }

  // Ring stage `slot` <- the unit's rows x its C_out tile (zeros past the
  // tile's valid channels).
  auto copy_weights = [&](const Unit& v, int slot) {
    const int nr = min(kChunk, rows - v.r0);
    const int co_valid = min(tile_cout, cout - v.cot * tile_cout);
    const T* src0 = wt + (size_t)v.r0 * cout + v.cot * tile_cout;
    T* dst0 = ws + slot * kChunk * ring_cout;
    if (st.vec_w) {  // 4 output channels a copy: 16 bytes of f32, 8 of bf16
#pragma unroll
      for (int it = 0; it < kCopies; ++it) {
        const int cc = copy_cc[it], co = copy_co[it];
        if (cc < nr) {
          const bool ok = co < co_valid;
          const T* src = ok ? src0 + (size_t)cc * cout + co : wt;
          if constexpr (sizeof(T) == 4)
            cp_async16(reinterpret_cast<float*>(dst0 + cc * tcp + co),
                       reinterpret_cast<const float*>(src), ok);
          else
            cp_async8(dst0 + cc * tcp + co, src, ok);
        }
      }
    } else {
      for (int idx = tid; idx < nr * tcp; idx += kThreads) {
        const int cc = idx / tcp, co = idx - cc * tcp;
        const bool ok = co < co_valid;
        const T* src = ok ? src0 + (size_t)cc * cout + co : wt;
        if constexpr (sizeof(T) == 4)
          cp_async4(reinterpret_cast<float*>(dst0 + cc * tcp + co),
                    reinterpret_cast<const float*>(src), ok);
        else  // no 2-byte cp.async: a plain load, seen after the barrier
          dst0[cc * tcp + co] = ok ? *src : T(0.0f);
      }
    }
  };

  Unit cur = {0, 0, 0, 0, 0, 0}, ahead = cur;
  copy_weights(ahead, 0);
  cp_async_commit();
  next(ahead);

  float acc[kSlots][kCout];
  int off[kSlots];  // each slot's window offset at tap (0, 0)
  int slot = 0;
  const int units = co_tiles * passes * ((rows + kChunk - 1) / kChunk);
  for (int u = 0; u < units; ++u) {
    cp_async_wait<0>();  // this thread's copies of ring stage u have landed
    __syncthreads();     // everyone's; and ring stage u-1 is consumed
    if (u + 1 < units) copy_weights(ahead, slot ^ 1);
    cp_async_commit();
    next(ahead);

    const int p0 = cur.pass * per_pass;
    if (cur.r0 == 0) {  // a new pass: zero the sums, place the slots
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
#pragma unroll
        for (int j = 0; j < kCout; ++j) acc[m][j] = 0.0f;
        int o = 0;  // idle slots read a valid address, never stored
        const int j = m / pw2, wm = m - j * pw2;
        const int p = p0 + ty + j * pthreads;
        if (j < st.per_thread && p < positions) {
          const int wi = wm / pw, wj = wm - wi * pw;
          const int pr = p / st.pool_cols, pc = p - pr * st.pool_cols;
          o = ((pr * ps + wi) * s * st.in_cols + (pc * ps + wj) * s) * pitch;
        }
        off[m] = o;
      }
    }

    if (computes) {
      const int nr = min(kChunk, rows - cur.r0);
      const T* wsb = ws + slot * kChunk * ring_cout + 4 * tx;
      int ki = cur.ki, kj = cur.kj, ci = cur.ci0;
      // the window at row cc's tap and channel; rows walk (kj, ki) forward
      auto step = [&](int by) {
        if ((ci += by) == cin) {
          ci = 0;
          if (++kj == k) {
            kj = 0;
            ++ki;
          }
        }
      };
      if (kVec) {
        // 4 rows of one tap: kSlots window float4s, 4 weight float4s
        auto mac4 = [&](const T* xb, int cc) {
          float4 xv[kSlots];
#pragma unroll
          for (int m = 0; m < kSlots; ++m) xv[m] = load4(xb + off[m]);
#pragma unroll
          for (int u4 = 0; u4 < 4; ++u4) {
            const float4 wv = load4(wsb + (cc + u4) * tcp);
#pragma unroll
            for (int m = 0; m < kSlots; ++m) {
              const float xu = u4 == 0   ? xv[m].x
                               : u4 == 1 ? xv[m].y
                               : u4 == 2 ? xv[m].z
                                         : xv[m].w;
              acc[m][0] = fmaf(xu, wv.x, acc[m][0]);
              acc[m][1] = fmaf(xu, wv.y, acc[m][1]);
              acc[m][2] = fmaf(xu, wv.z, acc[m][2]);
              acc[m][3] = fmaf(xu, wv.w, acc[m][3]);
            }
          }
        };
        if (nr == kChunk && ci + kChunk <= cin) {
          // a full ring stage in one tap: unrolled, loads hoisted
          const T* xsb = in + (ki * st.in_cols + kj) * pitch + ci;
#pragma unroll
          for (int cc = 0; cc < kChunk; cc += 4) mac4(xsb + cc, cc);
        } else {
#pragma unroll 1
          for (int cc = 0; cc < nr; cc += 4) {
            mac4(in + (ki * st.in_cols + kj) * pitch + ci, cc);
            step(4);
          }
        }
      } else {
#pragma unroll 1
        for (int cc = 0; cc < nr; ++cc) {
          const T* xb = in + (ki * st.in_cols + kj) * pitch + ci;
          const float4 wv = load4(wsb + cc * tcp);
#pragma unroll
          for (int m = 0; m < kSlots; ++m) {
            const float xu = to_f32(xb[off[m]]);
            acc[m][0] = fmaf(xu, wv.x, acc[m][0]);
            acc[m][1] = fmaf(xu, wv.y, acc[m][1]);
            acc[m][2] = fmaf(xu, wv.z, acc[m][2]);
            acc[m][3] = fmaf(xu, wv.w, acc[m][3]);
          }
          step(1);
        }
      }
    }

    if (computes && cur.r0 + kChunk >= rows) {
      // the pass's last unit: + bias, activation, max over each pool
      // window, mask
      const int cbase = cur.cot * tile_cout;
      const int co_valid = min(tile_cout, cout - cbase);
      float mx[kCout];
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        const int j = m / pw2, wm = m - j * pw2;
        const int p = p0 + ty + j * pthreads;
        if (j >= st.per_thread || p >= positions) continue;
#pragma unroll
        for (int jj = 0; jj < kCout; ++jj) {
          const int co = 4 * tx + jj;
          if (co >= co_valid) continue;
          float v = acc[m][jj];
          if (bias != nullptr) v = v + to_f32(bias[cbase + co]);
          v = activate(v, act);
          mx[jj] = wm == 0 ? v : fmaxf(mx[jj], v);
        }
        if (wm != pw2 - 1) continue;
        const int pr = p / st.pool_cols, pc = p - pr * st.pool_cols;
        const int gr = gr0 + pr, gc = gc0 + pc;
        const bool valid =
            gr >= 0 && gr < st.h_pool && gc >= 0 && gc < st.w_pool;
#pragma unroll
        for (int jj = 0; jj < kCout; ++jj) {
          const int co = 4 * tx + jj;
          if (co >= co_valid) continue;
          if (!last)
            store_elem(out + (pr * st.pool_cols + pc) * st.out_pitch + cbase +
                           co,
                       valid ? mx[jj] : 0.0f);
          else if (valid)
            store_elem(y + (((size_t)img * st.h_pool + gr) * st.w_pool + gc) *
                               cout +
                           cbase + co,
                       mx[jj]);
        }
      }
    }

    slot ^= 1;
    next(cur);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
trim_conv2d_fused_kernel(const T* __restrict__ x, T* __restrict__ y,
                         const __grid_constant__ FusedArgs a) {
  extern __shared__ float4 smem4[];
  T* const buf0 = reinterpret_cast<T*>(smem4);
  T* const buf1 = buf0 + a.buf0;
  T* const ws = buf1 + a.buf1;  // [kStages][kChunk][ring_cout]

  int bid = blockIdx.x;
  const int band = bid % a.n_bands; bid /= a.n_bands;
  const int strip = bid % a.n_strips;
  const int img = bid / a.n_strips;
  const int tid = threadIdx.x;

  {  // stage 0's input window, zeros outside the image; it lands with the
     // stage's first ring stage
    const StageArgs& s0 = a.st[0];
    const int r0 = s0.in_row_start + strip * s0.in_row_step;
    const int c0 = s0.in_col_start + band * s0.in_col_step;
    const T* xin = x + (size_t)img * a.h * a.w * a.cin;
    const int vx = a.vec_x ? 4 : 1;  // elements a copy
    const int per_px = a.cin / vx;
    const int total = s0.in_rows * s0.in_cols * per_px;
    for (int idx = tid; idx < total; idx += kThreads) {
      const int px = idx / per_px;
      const int ci = (idx - px * per_px) * vx;
      const int r = px / s0.in_cols, c = px - r * s0.in_cols;
      const int ih = r0 + r, iw = c0 + c;
      const bool in = ih >= 0 && ih < a.h && iw >= 0 && iw < a.w;
      const T* src = in ? xin + ((size_t)ih * a.w + iw) * a.cin + ci : x;
      T* dst = buf0 + px * s0.in_pitch + ci;
      if constexpr (sizeof(T) == 4) {
        if (a.vec_x)
          cp_async16(reinterpret_cast<float*>(dst),
                     reinterpret_cast<const float*>(src), in);
        else
          cp_async4(reinterpret_cast<float*>(dst),
                    reinterpret_cast<const float*>(src), in);
      } else if (a.vec_x) {
        cp_async8(dst, src, in);
      } else {  // no 2-byte cp.async: a plain load, seen after the barrier
        *dst = in ? *src : T(0.0f);
      }
    }
  }

  for (int i = 0; i < a.depth; ++i) {
    const StageArgs& st = a.st[i];
    const T* in = (i & 1) ? buf1 : buf0;
    T* out = (i & 1) ? buf0 : buf1;
    const bool last = i == a.depth - 1;
    const bool vec = st.cin % 4 == 0 && st.in_pitch % 4 == 0;
    if (st.pw == 3) {
      if (vec)
        run_stage<T, kPool3Positions, true>(st, last, a.activation, in, out,
                                            ws, a.ring_cout, y, img, strip,
                                            band);
      else
        run_stage<T, kPool3Positions, false>(st, last, a.activation, in, out,
                                             ws, a.ring_cout, y, img, strip,
                                             band);
    } else {
      if (vec)
        run_stage<T, kPositions, true>(st, last, a.activation, in, out, ws,
                                       a.ring_cout, y, img, strip, band);
      else
        run_stage<T, kPositions, false>(st, last, a.activation, in, out, ws,
                                        a.ring_cout, y, img, strip, band);
    }
    __syncthreads();  // this stage's output complete, its input and the
                      // ring fully read
  }
}

// Unpack the host geometry (layout in trim_conv2d_fused below); returns
// false for one the kernel cannot take.
template <typename T>
bool make_args(const T* x, const void* const* wb, const int* g,
               int activation, FusedArgs* a) {
  a->n = g[0]; a->h = g[1]; a->w = g[2]; a->cin = g[3]; a->depth = g[4];
  a->n_strips = g[5]; a->n_bands = g[6]; a->buf0 = g[7]; a->buf1 = g[8];
  a->ring_cout = 0; a->activation = activation;
  if (a->depth < 1 || a->depth > kMaxStages || a->n < 1 || a->n_strips < 1 ||
      a->n_bands < 1 || a->buf0 < 0 || a->buf1 < 0 || a->buf0 % 4 != 0 ||
      a->buf1 % 4 != 0)
    return false;
  for (int i = 0; i < a->depth; ++i) {
    const int* f = g + kHeader + i * kStageFields;
    StageArgs& st = a->st[i];
    st.w = wb[2 * i];
    st.b = wb[2 * i + 1];
    st.cin = f[0]; st.cout = f[1]; st.k = f[2]; st.stride = f[3];
    st.ps = f[4]; st.pw = f[5]; st.h_pool = f[6]; st.w_pool = f[7];
    st.in_rows = f[8]; st.in_cols = f[9];
    st.pool_rows = f[10]; st.pool_cols = f[11];
    st.in_row_start = f[12]; st.in_row_step = f[13];
    st.in_col_start = f[14]; st.in_col_step = f[15];
    st.pool_row_start = f[16]; st.pool_row_step = f[17];
    st.pool_col_start = f[18]; st.pool_col_step = f[19];
    st.tile_cout = f[20]; st.in_pitch = f[21];
    st.tcx = (st.tile_cout + kCout - 1) / kCout;
    st.per_thread = st.pw < 1 ? 0
                    : (st.pw == 3 ? kPool3Positions : kPositions) /
                          (st.pw * st.pw);
    st.vec_w = st.cout % 4 == 0 && st.tile_cout % 4 == 0 &&
               (uintptr_t)st.w % (4 * sizeof(T)) == 0;
    const int need_rows = ((st.pool_rows - 1) * st.ps + st.pw - 1) * st.stride + st.k;
    const int need_cols = ((st.pool_cols - 1) * st.ps + st.pw - 1) * st.stride + st.k;
    const long long tile = (long long)st.in_rows * st.in_cols * st.in_pitch;
    if (st.w == nullptr || st.cin < 1 || st.cout < 1 || st.k < 1 ||
        st.stride < 1 || st.ps < 1 || st.pw < 1 || st.pool_rows < 1 ||
        st.pool_cols < 1 || st.tile_cout < 1 || st.tile_cout > kMaxTileCout ||
        st.per_thread < 1 || st.in_pitch < st.cin || need_rows > st.in_rows ||
        need_cols > st.in_cols || tile > (i % 2 ? a->buf1 : a->buf0))
      return false;
    if (i == 0 ? st.cin != a->cin
               : (st.cin != a->st[i - 1].cout ||
                  st.in_rows != a->st[i - 1].pool_rows ||
                  st.in_cols != a->st[i - 1].pool_cols))
      return false;
    if (i > 0) a->st[i - 1].out_pitch = st.in_pitch;
    if (kCout * st.tcx > a->ring_cout) a->ring_cout = kCout * st.tcx;
  }
  a->st[a->depth - 1].out_pitch = 0;
  a->vec_x = a->cin % 4 == 0 && a->st[0].in_pitch % 4 == 0 &&
             (uintptr_t)x % (4 * sizeof(T)) == 0;
  return true;
}

template <typename T>
int launch(const T* x, T* y, const void* const* wb, const int* geom,
           int activation, void* stream) {
  FusedArgs a;
  if (!make_args(x, wb, geom, activation, &a))
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)a.buf0 + a.buf1 +
                       (size_t)kStages * kChunk * a.ring_cout) * sizeof(T);
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      trim_conv2d_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)a.n * a.n_strips * a.n_bands;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  trim_conv2d_fused_kernel<T><<<(unsigned)blocks, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(x, y, a);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes by repro_torch/kernels/build.py.
extern "C" {

// x: (n, h, w, cin) stage-0 input; y: (n, h_pool, w_pool, cout) of the last
// stage.  wb: host array of 2 * depth device pointers (w0, b0, w1, b1, ...;
// a bias may be null).  geom: host ints, kHeader of them (n, h, w, cin,
// depth, n_strips, n_bands, buf0, buf1), then kStageFields per stage in
// StageArgs' order from cin to in_pitch; buf0, buf1 and the pitches in
// elements of the entry's type (fuse_plan at dtype_bytes 4 or 2).
// Launches on `stream` without synchronising; returns cudaGetLastError(),
// or cudaErrorInvalidValue for a geometry the kernel cannot take.
int trim_conv2d_fused(const float* x, float* y, const void* const* wb,
                      const int* geom, int activation, void* stream) {
  return launch(x, y, wb, geom, activation, stream);
}

// The same on bf16 x, weights, biases and y.
int trim_conv2d_fused_bf16(const __nv_bfloat16* x, __nv_bfloat16* y,
                           const void* const* wb, const int* geom,
                           int activation, void* stream) {
  return launch(x, y, wb, geom, activation, stream);
}

const char* trim_conv2d_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
