// Fused residency group for NVIDIA Hopper (sm_90a), f32 and bf16,
// hand-written CUDA.
//
// Replaces the TPU Pallas kernel _fused_kernel of
// src/repro/kernels/trim_conv2d_fused.py (:102, with _stage_conv :67 and
// _stage_pool :87): a chain conv -> [max-pool] -> conv ... runs in one launch
// and every interior activation stays on chip.  trim_conv2d_fused takes f32
// operands, trim_conv2d_fused_bf16 bf16 ones (one templated kernel; its
// bf16 stages on the tensor cores where Cin is a multiple of 16).  The
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
// Order.  Every conv output element is summed in one fixed order that
// depends on nothing but the element -- the order trim_conv2d.cu takes for
// the same layer -- then + bias, then activate() of epilogue.cuh.
// Max-pooling picks one of its inputs exactly.  So a fused group is
// bitwise equal to the per-layer carry chain (conv kernel, then a separate
// max-pool), and a served row to forward_one.  No split of a sum across
// threads.  A stage's order is its route's (core/fuse_plan.py,
// stage_layout; the bf16 entry takes each stage's route and refuses one
// that is not its Cin's):
//  * f32, and bf16 stages whose Cin is not a multiple of 16 (route ffma:
//    VGG-16's conv1): ONE fmaf chain in (ki, kj, ci) order from 0.0f over
//    exactly ci < cin (run_stage above; no TF32).
//  * bf16 stages whose Cin is a multiple of 16 (route mma): the k-steps of
//    bf16_mma.cuh, one mma.sync m16n8k16 a run of 16 channels of one tap,
//    taps in order, into one f32 accumulator (run_stage_mma).  8 warps of
//    warps_m x warps_n, each with kBf16FusedMFrags m16 x 4 n8 fragments; A
//    by ldmatrix.x4 from the stage's input tile (one position's 8 channels
//    a lane address, at a pitch of cin + 8: 16-byte rows, an odd count of
//    quads), B by ldmatrix.x4.trans from a ring of kBf16FusedRingSlots
//    slots of kBf16FusedChunk (tap, channel) rows.  The M rows are ordered
//    so that each pool window lies in one thread's fragment rows (rows g
//    and g + 8 of its fragments), and the max-pool runs on the C fragments.
//
// bf16.  The T = __nv_bfloat16 instance keeps the input tile, the stage
// buffers and the weight ring in bf16; route ffma widens each value to f32
// exactly on read (elem.cuh), route mma feeds bf16 to the tensor cores
// (products exact, the sum f32).  + bias (bf16, widened: JAX casts the
// bias to the input dtype), activate(); each stage is rounded to bf16 once
// (__float2bfloat16_rn) where the JAX kernel casts it to the scratch dtype
// (:84), after the max over its pool window, which commutes with that
// monotone rounding.  So every stage is rounded exactly where the
// per-layer bf16 chain stores it, and fused == chain bitwise holds in
// bf16 on both routes.  A route-ffma stage's pitch is the f32 kernel's in
// elements (a copy of 4 channels is 8 bytes: the stage-0 window and the
// weights move as 8-byte cp.async copies, VGG-16's conv1 (cin 3) element
// by element: cp.async copies no 2-byte unit); a route-mma stage's is cin +
// 8, its weights 16-byte copies of 8 channels (BF16FusedGroup's layouts).
//
// What bounds it on the H100.  At VGG-16's early layers the group does
// hundreds of FLOPs per byte it must move, so the bound is operations:
// 67 TFLOP/s of non-tensor f32, 989 TFLOP/s of bf16 on the tensor cores
// (route mma reaches a part of it: small tiles, recomputed halos and M
// rows a small last stage leaves idle cost more than the bytes fusing
// saves; the plan picks tiles by bytes).  Fusing cuts the bytes the per-layer chain
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

#include "bf16_mma.cuh"
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
  int vec_w;       // weight copies of 4 channels (16 bytes f32, 8 bf16);
                   // route mma: of 8 channels (16 bytes)
  int mma;         // bf16 route mma (bf16_mma.cuh); 0: the fmaf chain
  int warps_n;     // route mma: warps along C_out
  int wp;          // route mma: elements of its weight-ring row
};

struct FusedArgs {
  int n, h, w, cin, depth, n_strips, n_bands;
  int buf0, buf1;   // elements of the ping-pong buffers (multiples of 4)
  int ring_cout;    // elements of one ring row: 4 x the widest stage's tcx
                    // (a stage on route mma: its wp)
  int ring_elems;   // elements of the weight ring: kStages slots of kChunk
                    // rows of ring_cout, or a route-mma stage's
                    // kBf16FusedRingSlots slots of kBf16FusedChunk rows of
                    // its wp
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

// One bf16 stage on route mma (bf16_mma.cuh) of one tile: an implicit GEMM
// on the tensor cores, every C_out tile and pass, weights through the same
// ring.  8 warps of warps_m x warps_n, each with kBf16FusedMFrags m16 x 4 n8
// fragments.  Rows are ordered so that each pool window lies in one
// thread's fragment rows: the thread of group g in warp wm holds rows g and
// g + 8 of its fragments f, slots sg = 2 f + (0, 1), and window w of its
// per_thread takes slots [w pw^2, (w + 1) pw^2); the window's pooled
// position is p0 + (wm per_thread + w) 8 + g (neighbouring groups:
// neighbouring positions, so an ldmatrix phase of a pool-free stage reads
// positions one pitch apart).  The max-pool then runs on the C fragments
// after bias and activate(), and one rounding to bf16 follows it.
__device__ __noinline__ void run_stage_mma(
    const StageArgs& st, bool last, int act, const __nv_bfloat16* in,
    __nv_bfloat16* out, __nv_bfloat16* ws, __nv_bfloat16* __restrict__ y,
    int img, int strip, int band) {
  using bf16 = __nv_bfloat16;
  constexpr int kMF = kBf16FusedMFrags;
  const bf16* const wt = static_cast<const bf16*>(st.w);
  const bf16* const bias = static_cast<const bf16*>(st.b);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wn = warp % st.warps_n, wm = warp / st.warps_n;
  const int g = lane / 4, tq = lane % 4;
  const int cin = st.cin, cout = st.cout, k = st.k, s = st.stride;
  const int ps = st.ps, pw = st.pw, pw2 = st.pw * st.pw;
  const int wins = st.per_thread;              // windows a thread
  const int per_pass = kThreads / 32 / st.warps_n * 8 * wins;
  const int positions = st.pool_rows * st.pool_cols;
  const int passes = (positions + per_pass - 1) / per_pass;
  const int tile_cout = st.tile_cout, wp = st.wp;
  const int n_blk = kBf16WarpN * st.warps_n;
  const int co_tiles = (cout + tile_cout - 1) / tile_cout;
  const int pitch = st.in_pitch;
  const int gr0 = st.pool_row_start + strip * st.pool_row_step;
  const int gc0 = st.pool_col_start + band * st.pool_col_step;

  // the weights as rows (ki, kj, ci) x C_out, kBf16FusedChunk rows (four
  // k-steps) a ring slot, one slot computing while the next lands
  constexpr int kRows = kBf16FusedChunk, kSlots = kBf16FusedRingSlots;
  const int rows = k * k * cin;
  struct Unit { int cot, pass, r0, ki, kj, ci0; };
  auto next = [&](Unit& v) {
    v.r0 += kRows;
    if (v.r0 >= rows) {
      v.r0 = v.ki = v.kj = v.ci0 = 0;
      if (++v.pass == passes) {
        v.pass = 0;
        ++v.cot;
      }
      return;
    }
    for (v.ci0 += kRows; v.ci0 >= cin; v.ci0 -= cin)
      if (++v.kj == k) {
        v.kj = 0;
        ++v.ki;
      }
  };

  // Ring slot `slot` <- the unit's rows x the tile's n_blk channels at
  // the stage's row pitch wp (zeros past the tile's valid channels).
  auto copy_weights = [&](const Unit& v, int slot) {
    const int nr = min(kRows, rows - v.r0);
    const int co_valid = min(tile_cout, cout - v.cot * tile_cout);
    const bf16* src0 = wt + (size_t)v.r0 * cout + v.cot * tile_cout;
    bf16* dst0 = ws + slot * kRows * wp;
    if (st.vec_w) {  // 8 output channels a 16-byte copy
      const int per_row = n_blk / 8;
      for (int idx = tid; idx < nr * per_row; idx += kThreads) {
        const int cc = idx / per_row, co = (idx - cc * per_row) * 8;
        const bool ok = co < co_valid;
        const bf16* src = ok ? src0 + (size_t)cc * cout + co : wt;
        cp_async16(reinterpret_cast<float*>(dst0 + cc * wp + co),
                   reinterpret_cast<const float*>(src), ok);
      }
    } else {
      for (int idx = tid; idx < nr * n_blk; idx += kThreads) {
        const int cc = idx / n_blk, co = idx - cc * n_blk;
        dst0[cc * wp + co] = co < co_valid ? src0[(size_t)cc * cout + co]
                                           : __float2bfloat16_rn(0.0f);
      }
    }
  };

  // this lane's B rows (bf16_mma.cuh): k row (lane & 7) + 8 ((lane >> 3)
  // & 1), channels 8 (lane >> 4) on of its warp's
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * wp +
                    wn * kBf16WarpN + (lane >> 4) * 8;

  const int units = co_tiles * passes * ((rows + kRows - 1) / kRows);
  Unit cur = {0, 0, 0, 0, 0, 0}, ahead = cur;
  copy_weights(ahead, 0);  // a stage-0 window rides on this commit
  cp_async_commit();
  next(ahead);

  float acc[kMF][4][4];
  int a_off[kMF];  // each fragment's A row at tap (0, 0), channel 0
  for (int u = 0; u < units; ++u) {
    const int slot = u % kSlots;
    cp_async_wait<0>();  // this thread's copies of unit u have landed
    __syncthreads();     // everyone's; and unit u-1 is consumed
    if (u + 1 < units) copy_weights(ahead, (u + 1) % kSlots);
    cp_async_commit();
    next(ahead);

    const int p0 = cur.pass * per_pass;
    if (cur.r0 == 0) {  // a new pass: zero the sums, place the A rows
#pragma unroll
      for (int f = 0; f < kMF; ++f) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[f][j][r] = 0.0f;
        // the row this lane addresses: slot 2 f + ((lane >> 3) & 1) of
        // group lane & 7; idle rows read a valid address, never stored
        const int sg = 2 * f + ((lane >> 3) & 1);
        const int w = sg / pw2, e = sg - w * pw2;
        const int p = p0 + (wm * wins + w) * 8 + (lane & 7);
        int o = 0;
        if (w < wins && p < positions) {
          const int wi = e / pw, wj = e - wi * pw;
          const int pr = p / st.pool_cols, pc = p - pr * st.pool_cols;
          o = ((pr * ps + wi) * s * st.in_cols + (pc * ps + wj) * s) * pitch;
        }
        a_off[f] = o + (lane >> 4) * 8;
      }
    }

    // the unit's k-steps, in the contract's order (bf16_mma.cuh)
    KStep ks = {cur.ki, cur.kj, cur.ci0};
    const bf16* wsb = ws + slot * kRows * wp + b_off;
    auto load = [&](int q, uint32_t (&af)[kMF][4], uint32_t (&bf)[4][2]) {
      const bf16* bq0 = wsb + q * kBf16MmaK * wp;
      ldsm_x4_trans(bq0, bf[0], bf[1]);
      ldsm_x4_trans(bq0 + 2 * kBf16MmaN, bf[2], bf[3]);
      const bf16* xb = in + (ks.ki * st.in_cols + ks.kj) * pitch + ks.ci0;
#pragma unroll
      for (int f = 0; f < kMF; ++f) ldsm_x4(xb + a_off[f], af[f]);
      ks.next(cin, k);
    };
    bf16_mma_steps<kRows / kBf16MmaK>(
        acc, kMF, min(kRows, rows - cur.r0) / kBf16MmaK, load);

    if (cur.r0 + kRows >= rows) {
      // the pass's last unit: + bias, activation, max over each pool
      // window in this thread's slots, mask, one rounding
      const int cbase = cur.cot * tile_cout;
      const int co_valid = min(tile_cout, cout - cbase);
      float bq[4][2], mx[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = wn * kBf16WarpN + j * kBf16MmaN + 2 * tq + e;
          bq[j][e] = bias != nullptr && co < co_valid
                         ? to_f32(bias[cbase + co]) : 0.0f;
        }
#pragma unroll
      for (int sg = 0; sg < 2 * kMF; ++sg) {
        const int w = sg / pw2, e_i = sg - w * pw2;
        if (w >= wins) break;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = acc[sg >> 1][j][2 * (sg & 1) + e];
            if (bias != nullptr) v = v + bq[j][e];
            v = activate(v, act);
            mx[j][e] = e_i == 0 ? v : fmaxf(mx[j][e], v);
          }
        if (e_i != pw2 - 1) continue;
        const int p = p0 + (wm * wins + w) * 8 + g;
        if (p >= positions) continue;
        const int pr = p / st.pool_cols, pc = p - pr * st.pool_cols;
        const int gr = gr0 + pr, gc = gc0 + pc;
        const bool valid =
            gr >= 0 && gr < st.h_pool && gc >= 0 && gc < st.w_pool;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = wn * kBf16WarpN + j * kBf16MmaN + 2 * tq + e;
            if (co >= co_valid) continue;
            if (!last)
              store_elem(out + (pr * st.pool_cols + pc) * st.out_pitch +
                             cbase + co,
                         valid ? mx[j][e] : 0.0f);
            else if (valid)
              store_elem(y + (((size_t)img * st.h_pool + gr) * st.w_pool +
                              gc) * cout + cbase + co,
                         mx[j][e]);
          }
      }
    }

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
  T* const ws = buf1 + a.buf1;  // [kStages][kChunk][ring_cout], or a
                                // route-mma stage's slots (ring_elems)

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
    if constexpr (sizeof(T) == 2) {
      if (st.mma) {
        run_stage_mma(st, last, a.activation, in, out, ws, y, img, strip,
                      band);
        __syncthreads();
        continue;
      }
    }
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
// false for one the kernel cannot take.  `routes` (the bf16 entry's; null
// for f32): each stage's route, 1 mma or 0 ffma, refused unless it is the
// stage's own (bf16 and Cin a multiple of 16: mma; core/conv_plan.py,
// bf16_route).
template <typename T>
bool make_args(const T* x, const void* const* wb, const int* g,
               const int* routes, int activation, FusedArgs* a) {
  a->n = g[0]; a->h = g[1]; a->w = g[2]; a->cin = g[3]; a->depth = g[4];
  a->n_strips = g[5]; a->n_bands = g[6]; a->buf0 = g[7]; a->buf1 = g[8];
  a->ring_cout = 0; a->ring_elems = 0; a->activation = activation;
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
    st.mma = routes == nullptr ? 0 : routes[i];
    if (st.mma != (int)(sizeof(T) == 2 && st.cin % kBf16MmaK == 0))
      return false;
    st.tcx = (st.tile_cout + kCout - 1) / kCout;
    if (st.mma) {
      // whole pool windows in a thread's 2 kBf16FusedMFrags fragment rows;
      // warps along C_out 1, 2 or 4 (the plan's stage_layout)
      st.warps_n = st.tile_cout <= kBf16WarpN ? 1
                   : st.tile_cout <= 2 * kBf16WarpN ? 2 : 4;
      st.wp = kBf16WarpN * st.warps_n + kBf16RowPad;
      st.per_thread = st.pw < 1 ? 0 : 2 * kBf16FusedMFrags / (st.pw * st.pw);
      st.vec_w = st.cout % 8 == 0 && st.tile_cout % 8 == 0 &&
                 (uintptr_t)st.w % 16 == 0;
      if (st.in_pitch % 8 != 0 || a->buf0 % 8 != 0 || a->buf1 % 8 != 0)
        return false;
    } else {
      st.warps_n = st.wp = 0;
      st.per_thread = st.pw < 1 ? 0
                      : (st.pw == 3 ? kPool3Positions : kPositions) /
                            (st.pw * st.pw);
      st.vec_w = st.cout % 4 == 0 && st.tile_cout % 4 == 0 &&
                 (uintptr_t)st.w % (4 * sizeof(T)) == 0;
    }
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
    const int ring_row = st.mma ? st.wp : kCout * st.tcx;
    if (ring_row > a->ring_cout) a->ring_cout = ring_row;
    if (st.mma && kBf16FusedRingSlots * kBf16FusedChunk * st.wp >
                      a->ring_elems)
      a->ring_elems = kBf16FusedRingSlots * kBf16FusedChunk * st.wp;
  }
  if (kStages * kChunk * a->ring_cout > a->ring_elems)
    a->ring_elems = kStages * kChunk * a->ring_cout;
  a->st[a->depth - 1].out_pitch = 0;
  a->vec_x = a->cin % 4 == 0 && a->st[0].in_pitch % 4 == 0 &&
             (uintptr_t)x % (4 * sizeof(T)) == 0;
  return true;
}

template <typename T>
int launch(const T* x, T* y, const void* const* wb, const int* geom,
           const int* routes, int activation, void* stream) {
  FusedArgs a;
  if (!make_args(x, wb, geom, routes, activation, &a))
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)a.buf0 + a.buf1 + a.ring_elems) * sizeof(T);
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
  return launch(x, y, wb, geom, nullptr, activation, stream);
}

// The same on bf16 x, weights, biases and y; `routes`: a host array of
// each stage's route (1 mma, 0 ffma), the plan's.
int trim_conv2d_fused_bf16(const __nv_bfloat16* x, __nv_bfloat16* y,
                           const void* const* wb, const int* geom,
                           const int* routes, int activation, void* stream) {
  return launch(x, y, wb, geom, routes, activation, stream);
}

const char* trim_conv2d_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
