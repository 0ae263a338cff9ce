// 3D-TrIM convolution for NVIDIA Hopper (sm_90a), int8 route, hand-written
// CUDA.
//
// Replaces the int8 route (has_scale=True) of the TPU Pallas kernels of
// src/repro/kernels/trim_conv2d.py:
//   trim_conv2d_q8_carry -> _carry_kernel (:127), with _tap_matmuls' int32
//                           accumulator (:82-100) and _epilogue_store's
//                           dequant (:103-124), dataflow="carry"
//   trim_conv2d_q8_halo  -> _halo_kernel (:162), dataflow="halo"
// Both entries launch the same kernels; as in trim_conv2d.cu, the two
// dataflows differ only in how many strips one block walks, and they are
// bitwise equal (an integer sum is exact in any order).
//
// Math.  acc[n,oh,ow,g*Cpg+co] = sum_{ki,kj,ci} xpad[n, oh*s+ki, ow*s+kj,
// g*Cin_pg+ci] * w[ki,kj,ci,g*Cpg+co] over int8 operands in an int32
// accumulator (exact; no .satfinite, the plain sum does not clamp), then
//   y = activate(__fmul_rn(__int2float_rn(acc + bias_q[co]), scale[co]))
// with bias_q (int32) and scale (f32) from ref.dequant_params: one exact
// int32 add, one rounded int -> f32 conversion and one rounded multiply,
// written with the _rn intrinsics so that nvcc cannot contract the multiply
// into the activation's arithmetic (gelu's v + c v^3) as an FMA.  The
// virtual 'same' padding reads the activation ZERO POINT, not 0 (the JAX
// path pre-pads with it, ops.py:750-755): the zero-point correction in
// bias_q assumes every tap of every output sees a quantized value.
//
// Weights (kernels/trim_conv2d.py, pack_q8_weights): K-major rows, one an
// output channel, (Cout, K, K, C) int8 flattened and zero-padded to kpad =
// K*K*C rounded up to a 32-byte k-step; C (ctap) is Cin/g rounded up to 4,
// or to 32 where Cin/g is a multiple of 16 (so a k-step never spans two
// taps: a 16-channel tail is zero in the row, and so in the weight stage).
//
// Geometry (core/conv_plan.py, ConvPlan with dtype_bytes=1).  A block owns
// (image, group, C_out tile, column band) and one segment of the band's
// strips; its window, a ring of padded input rows x window columns x
// cin_stride BYTES, lives in shared memory, and strip t+1 reuses the K-s
// rows strip t holds (the shadow registers); where the ring holds
// 2 TH + K-s rows the next strip's fresh rows land while this one
// computes.  Three routes, the plan's choice, checked by the launcher:
//
//  * mma (Cin/g a multiple of 16: VGG-16 conv2-13).  An implicit GEMM on
//    mma.sync.m16n8k32.s32.s8.s8.s32: M = the strip's positions, N = the
//    C_out tile, K = (ki, kj, ci) in k-steps of 32 channels of one tap (a
//    16-channel tail zero-padded in the packed row).  8 warps of
//    warps_m x warps_n x warps_k, each with m_frags m16 x 4 n8 int32
//    fragments in registers: instances of up to 4 fragments (one block an
//    SM; the next k-step's fragments loaded before this one's products)
//    and up to 2 (two blocks an SM in 128 registers).  A comes by ldmatrix.x4 straight from the
//    window: each lane gives the address of one position's 16 channels at
//    tap (ki, kj), so the implicit-GEMM gather costs nothing.  The window's
//    columns are stored phase-split by the stride (column c at slot
//    (c % s) * ceil(cols / s) + c / s), so positions one output column
//    apart are one pitch apart at every tap, and the plan picks a pitch of
//    an odd count of 16-byte quads: the 8 rows of an ldmatrix phase hit 8
//    distinct bank quads; each ring row is padded so that a phase which
//    crosses output rows does too (row_bytes).  (At stride 2 an unsplit
//    window cannot do that: pitch * 2 / 16 is even for any 16-byte-aligned
//    pitch.)  B comes by
//    ldmatrix.x4 from a 3-stage cp.async ring of [tile rows of 32 x
//    warps_n output channels] x [4 k-steps + 16 bytes of pad] bytes.
//  * im2col (groups == 1, small Cin: conv1's Cin 3, K*K*Cin4 = 36).  The
//    window holds Cin4 bytes a position; at each strip the block builds an
//    im2col tile (positions x kpad bytes, zero past K*K*Cin4) from it, then
//    runs the same MMA loop over kpad / 32 k-steps (two at conv1, instead
//    of nine taps of one __dp4a word).  The weight rows are zero past
//    K*K*Cin4, so the padding adds 0.
//  * dp4a (depthwise and other grouped convs with Cin/g < 16).  The
//    first design's loop: one output channel an A tile leaves the tensor cores nothing to
//    fill.  256 threads of tcx = ceil(tile_cout / 4) along C_out, each
//    with 8 positions x 4 channels of int32 accumulators, a __dp4a a word
//    of 4 channels; weights through a 2-stage ring of [64 channels of one
//    tap] x [tile_cout] words, transposed from the K-major rows as they
//    are copied.
//
// Epilogue (mma, im2col): bias_q added to the C fragments, then
// __int2float_rn, __fmul_rn, activate(); each warp stages its m16 x 32
// results in shared memory and stores whole 16-byte pieces, 128 bytes of
// one position's row a quarter warp.  With warps_k > 1 (small M tiles) the
// warps that share an output tile add their partial sums through the same
// staging first (exact: integers).
//
// What bounds it on the H100.  The function is bound by bytes on VGG-16
// (int8 in, f32 out: conv2's output is 80% of its bytes at N=8) against
// the tensor cores' 1,979 TOPS; mma.sync takes the products off the
// integer pipes (the __dp4a ceiling was ~134 TOPS).  The kernel itself is
// bound by latency: a weight stage's k-steps and the issue of its
// cp.async copies take most of a stage, the MMAs and the stores little
// (tools/q8_ablation.py), far below mma.sync's own rate.  wgmma with
// TMA-fed operands is a later design (wgmma's shared-memory descriptors
// need an im2col A tile).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;        // threads per block (CONV_THREADS)
constexpr int kWarps = 8;            // warps per block
constexpr int kMmaM = 16;            // positions of one A fragment
constexpr int kMmaN = 8;             // output channels of one C fragment
constexpr int kMmaK = 32;            // bytes of k of one k-step
constexpr int kWarpN = 32;           // output channels a warp (4 fragments)
constexpr int kMaxMFrags = 4;        // m16 fragments a warp at most ...
constexpr int kMaxMFragsTwo = 2;     // ... and in the two-blocks-an-SM instance
constexpr int kStageSteps = 4;       // k-steps of one weight stage
constexpr int kStages = 3;           // the weight ring's stages
constexpr int kRowPad = 16;          // bytes past each stage / im2col row
constexpr int kStagingBytes = 16 * (kWarpN + 4) * 4;  // a warp's staging
constexpr int kIm2colMaxK = 256;     // longest im2col row (kpad)
constexpr int kPositions = 8;        // dp4a: output positions a thread
constexpr int kCout = 4;             // dp4a: output channels a thread
constexpr int kQuad = 4;             // input channels of one __dp4a word
constexpr int kVec = 16;             // input channels of one 16-byte copy
constexpr int kChunk = 64;           // dp4a: channels of one tap a stage
constexpr int kDp4aStages = 2;       // dp4a: its weight ring's stages
constexpr int kMaxSmemBytes = 232448;  // H100: 227 KB opt-in per block
constexpr int kSmemPerSm = 233472;     // H100: 228 KB an SM
constexpr int kReservedSmem = 1024;    // the runtime's share of each block

constexpr int kWPitch = kStageSteps * kMmaK + kRowPad;  // 144: 9 quads

enum Route { kRouteMma = 0, kRouteIm2col = 1, kRouteDp4a = 2 };

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
  int route, warps_n, warps_k, m_frags;   // the plan's route and warps
  // derived by launch()
  int cin_pg;        // Cin/g
  int cin4;          // Cin/g rounded up to kQuad
  int ctap;          // bytes of a tap in a packed weight row
  int kpad;          // bytes of a packed weight row
  int n_strips, n_bands, co_tiles, segments;
  int tcx;           // dp4a: threads along C_out, ceil(tile_cout / 4)
  int vec_x;         // mma: window copied in 16-byte cp.async
  int word_x;        // window words loaded whole (Cin/g % 4 == 0)
  int vec_y;         // output rows of the tile are 16-byte aligned
  int k_steps;       // mma / im2col: k-steps a strip
  int stages;        // mma / im2col: weight stages a strip
};

__host__ __device__ inline int window_cols(const Q8Args& a) {
  return (a.tile_w - 1) * a.stride + a.k;
}

// Window columns of one stride phase (mma / im2col: the window is stored
// phase-split) and the columns a ring row holds.
__host__ __device__ inline int phase_cols(const Q8Args& a) {
  return (window_cols(a) + a.stride - 1) / a.stride;
}

__host__ __device__ inline int col_slots(const Q8Args& a) {
  return a.route == kRouteDp4a ? window_cols(a) : a.stride * phase_cols(a);
}

// Bytes of one ring row.  mma: the columns plus the fewest 16-byte quads
// that make the next output row (stride rows on) continue the bank-quad
// sequence of this one, so an ldmatrix phase that crosses output rows
// stays conflict free (none where the stride and band make that
// impossible).
__host__ __device__ inline int row_bytes(const Q8Args& a) {
  const int cols = col_slots(a) * a.cin_stride;
  if (a.route != kRouteMma) return cols;
  const int quads = a.cin_stride / 16;
  for (int d = 0; d < 8; ++d)
    if ((a.stride * (cols / 16 + d) - a.tile_w * quads) % 8 == 0)
      return cols + 16 * d;
  return cols;
}

// Bytes of the window ring, rounded to 16 so the next region aligns.
__host__ __device__ inline int window_bytes(const Q8Args& a) {
  return (a.ring_rows * row_bytes(a) + 15) / 16 * 16;
}

__host__ __device__ inline int warps_m(const Q8Args& a) {
  return kWarps / (a.warps_n * a.warps_k);
}

__host__ __device__ inline int mma_slots(const Q8Args& a) {
  return kMmaM * a.m_frags * warps_m(a);
}

inline size_t smem_bytes(const Q8Args& a) {
  if (a.route == kRouteDp4a)
    return (size_t)window_bytes(a) +
           (size_t)kDp4aStages * kChunk * kCout * a.tcx;
  size_t s = (size_t)window_bytes(a) +
             (size_t)kStages * kWarpN * a.warps_n * kWPitch +
             (size_t)kWarps * kStagingBytes;
  if (a.route == kRouteIm2col)
    s += (size_t)mma_slots(a) * (a.kpad + kRowPad);
  return s;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(p)));
}

// c += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 exact.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block coordinates shared by both kernels.
struct Tile {
  int band, cot, grp, img, t_first, t_last, col0, co_base, co_valid;
  const int8_t* xin;
};

__device__ __forceinline__ Tile tile_of(const Q8Args& a, const int8_t* x) {
  Tile t;
  int b = blockIdx.x;
  t.band = b % a.n_bands; b /= a.n_bands;
  t.cot = b % a.co_tiles; b /= a.co_tiles;
  t.grp = b % a.groups;
  t.img = b / a.groups;
  t.t_first = blockIdx.y * a.strips_per_seg;
  t.t_last = min(t.t_first + a.strips_per_seg, a.n_strips);
  t.col0 = t.band * a.tile_w * a.stride - a.pad_left;
  const int cin_pg = a.cin / a.groups, cout_pg = a.cout / a.groups;
  t.xin = x + (size_t)t.img * a.h * a.w * a.cin + t.grp * cin_pg;
  t.co_base = t.grp * cout_pg + t.cot * a.tile_cout;
  t.co_valid = min(a.tile_cout, cout_pg - t.cot * a.tile_cout);
  return t;
}

// Copies part `part` of `parts` of padded rows [r0, r0 + rows) of the band
// into their ring slots; positions outside the image read the zero point.
// 16-byte route (kVec channels a copy): cp.async from the image, plain
// stores of the zero point.  Word route: a word of 4 channels a copy,
// channels past Cin/g zero.  `phase` stores the columns phase-split.
__device__ __forceinline__ void copy_window_rows(
    const Q8Args& a, const Tile& tl, int8_t* xs, int r0, int rows, int part,
    int parts, bool vec, bool phase) {
  const int cin_pg = a.cin / a.groups;
  const int wc = window_cols(a);
  const int pc = phase_cols(a);
  const int row_len = row_bytes(a);
  const int per_col = vec ? cin_pg / kVec : a.cin4 / kQuad;
  const int units = wc * per_col;
  const int total = rows * units;
  const int per = (total + parts - 1) / parts;
  const int end = min(total, (part + 1) * per);
  const uint32_t zp4 = 0x01010101u * (uint32_t)(uint8_t)a.zero_point;
  for (int idx = part * per + (int)threadIdx.x; idx < end; idx += kThreads) {
    const int r = idx / units;
    const int rem = idx - r * units;
    const int c = rem / per_col;
    const int ci = (rem - c * per_col) * (vec ? kVec : kQuad);
    const int ih = r0 + r - a.pad_top;
    const int iw = tl.col0 + c;
    const bool in = ih >= 0 && ih < a.h && iw >= 0 && iw < a.w;
    const int8_t* src =
        in ? tl.xin + ((size_t)ih * a.w + iw) * a.cin + ci : tl.xin;
    const int slot = phase ? (c % a.stride) * pc + c / a.stride : c;
    int8_t* dst = xs + ((r0 + r) % a.ring_rows) * row_len +
                  slot * a.cin_stride + ci;
    if (vec) {
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
}

// ---------------------------------------------------------------------------
// The tensor-core routes (mma, im2col)
// ---------------------------------------------------------------------------

// kMF: the instance's m16 fragments a warp (m_frags <= kMF): 4 with one
// block an SM, 2 where two share an SM in 128 registers without spilling.
template <bool kIm2col, int kMF, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
trim_conv2d_q8_mma_kernel(const int8_t* __restrict__ x,
                          const int8_t* __restrict__ wq,
                          const int* __restrict__ bias,
                          const float* __restrict__ scale,
                          float* __restrict__ y, const Q8Args a) {
  extern __shared__ int4 smem4[];
  int8_t* xs = reinterpret_cast<int8_t*>(smem4);
  const int n_blk = kWarpN * a.warps_n;        // weight rows of a stage
  int8_t* ws = xs + window_bytes(a);
  float* stg = reinterpret_cast<float*>(ws + kStages * n_blk * kWPitch);
  int8_t* im = reinterpret_cast<int8_t*>(stg + kWarps * kStagingBytes / 4);

  const Tile tl = tile_of(a, x);
  const int s = a.stride, k = a.k;
  const int th = a.tile_h_out * s;            // fresh input rows per strip
  const int kc = k > s ? k - s : 0;           // rows carried to the next strip
  const int pc = phase_cols(a);
  const int row_len = row_bytes(a);           // bytes per ring slot
  const int positions = a.tile_h_out * a.tile_w;
  const int slots = mma_slots(a);
  const int ipitch = a.kpad + kRowPad;        // im2col row: an odd # of quads
  const int cpt = a.ctap / kMmaK;             // mma: k-steps a tap
  // mma: the last k-step of a tap holds 16 channels (the rest zero weights)
  const bool tail = a.cin_pg % kMmaK != 0;
  const int n_st = a.stages;
  const int strips = tl.t_last - tl.t_first;
  const int total_st = strips * n_st;         // the segment's weight stream
  // the next strip's rows ride on the first stages' commits; where a strip
  // has too few stages for them to land by the next strip's first wait,
  // that wait drains every copy
  const bool prefetch = a.ring_rows >= 2 * th + kc;
  const int pf_parts = max(1, n_st - kStages + 2);
  const bool drain = !prefetch || n_st - kStages + 2 < 1;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wn = warp % a.warps_n;
  const int wk = (warp / a.warps_n) % a.warps_k;
  const int wm = warp / (a.warps_n * a.warps_k);
  const int g = lane / 4, tq = lane % 4;      // fragment row / column pair

  // Weight stage: k-steps [4 ls, 4 ls + 4) of the tile's rows.  A thread's
  // 16-byte copies are fixed: rows tid / 8 + 32 u, k-step (tid / 2) % 4,
  // half tid % 2; zeros past the valid channels and the row's k-steps.
  const int w_row0 = threadIdx.x >> 3, w_q = (threadIdx.x >> 1) & 3;
  const int w_off = w_q * kMmaK + (threadIdx.x & 1) * 16;
  auto issue = [&](int gs) {
    if (gs >= total_st) return;
    const int ls = gs % n_st;
    const bool ks_ok = ls * kStageSteps + w_q < a.k_steps;
    int8_t* dst = ws + (gs % kStages) * n_blk * kWPitch + w_row0 * kWPitch +
                  w_off;
    for (int u = 0; u < n_blk / 32; ++u) {
      const int row = w_row0 + 32 * u;
      const bool ok = ks_ok && row < tl.co_valid;
      const int8_t* src =
          ok ? wq + (size_t)(tl.co_base + row) * a.kpad +
                   ls * kStageSteps * kMmaK + w_off
             : wq;
      cp_async16(reinterpret_cast<float*>(dst + u * 32 * kWPitch),
                 reinterpret_cast<const float*>(src), ok);
    }
  };

  // this lane's ldmatrix rows.  B: n fragments (0, 1) and (2, 3), two x4
  // loads; A: its position in each m fragment (clamped to a valid one;
  // such rows are never stored), k bytes 0-15 or 16-31
  const int b_off = (wn * kWarpN + ((lane >> 4) & 1) * kMmaN + (lane & 7)) *
                        kWPitch + ((lane >> 3) & 1) * 16;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_half = (lane >> 4) * 16;
  auto a_pos = [&](int i) {
    return min((wm * a.m_frags + i) * kMmaM + a_row, positions - 1);
  };
  int a_col[kMF];                             // mma: its output column
  int a_im[kMF];                              // im2col: its tile row's bytes
#pragma unroll
  for (int i = 0; i < kMF; ++i) {
    a_col[i] = a_pos(i) % a.tile_w;
    a_im[i] = ((wm * a.m_frags + i) * kMmaM + a_row) * ipitch + a_half;
  }

  // the first window whole, with the first weight stages
  copy_window_rows(a, tl, xs, tl.t_first * th, th + kc, 0, 1, a.vec_x != 0,
                   true);
  issue(0);
  cp_async_commit();
#pragma unroll
  for (int i = 1; i < kStages - 1; ++i) {
    issue(i);
    cp_async_commit();
  }

  float* my_stg = stg + warp * (kStagingBytes / 4);
  int gs = 0;                                  // global stage index
  for (int t = tl.t_first; t < tl.t_last; ++t) {
    const bool has_next = t + 1 < tl.t_last;
    if (t > tl.t_first && !prefetch) {
      // the fresh rows replace strip t-1's first TH rows: every thread is
      // done with strip t-1
      __syncthreads();
      copy_window_rows(a, tl, xs, t * th + kc, th, 0, 1, a.vec_x != 0, true);
      cp_async_commit();
    }

    int acc[kMF][4][4];
#pragma unroll
    for (int i = 0; i < kMF; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

    // this strip's ring row of each fragment's position at ki = 0
    int rbase[kMF];
#pragma unroll
    for (int i = 0; i < kMF; ++i)
      rbase[i] = (t * th + a_pos(i) / a.tile_w * s) % a.ring_rows;

    // mma: the k cursor of this warp, k-steps wk, wk + warps_k, ... (a
    // stage holds kStageSteps, a multiple of warps_k, so the sequence runs
    // on across stages): chunk cc of tap (ki, kj), kj = qt * s + ph; a_off
    // holds the rows' window bytes at the tap
    int cc = wk, ki = 0, kj = 0, ph = 0, qt = 0;
    int a_off[kMF];
    auto tap_offsets = [&]() {
      const int colk = ph * pc + qt;
#pragma unroll
      for (int i = 0; i < kMF; ++i) {
        int slot = rbase[i] + ki;
        if (slot >= a.ring_rows) slot -= a.ring_rows;
        a_off[i] = slot * row_len + (a_col[i] + colk) * a.cin_stride +
                   a_half;
      }
    };
    auto next_tap = [&]() {
      if (++kj == k) {
        kj = ph = qt = 0;
        ++ki;
      } else if (++ph == s) {
        ph = 0;
        ++qt;
      }
    };
    if (!kIm2col) {
      while (cc >= cpt) {
        cc -= cpt;
        next_tap();
      }
      tap_offsets();
    }

    for (int st = 0; st < n_st; ++st, ++gs) {
      if (st == 0 && t > tl.t_first && drain)
        cp_async_wait<0>();          // the fresh rows, committed last
      else
        cp_async_wait<kStages - 2>();  // stage gs (and the rows) landed
      __syncthreads();               // everyone's; stage gs-1 consumed
      issue(gs + kStages - 1);       // into the buffer stage gs-1 freed
      if (prefetch && has_next && st < pf_parts)
        copy_window_rows(a, tl, xs, (t + 1) * th + kc, th, st, pf_parts,
                         a.vec_x != 0, true);
      cp_async_commit();

      if (kIm2col && st == 0) {
        // the strip's im2col tile, a row a thread: the words of taps
        // (ki, kj) from the window, zero past K*K*Cin4 and for idle rows
        const int words = a.kpad / 4, tap_words = a.cin4 / 4;
        for (int p = threadIdx.x; p < slots; p += kThreads) {
          uint32_t* row = reinterpret_cast<uint32_t*>(im + p * ipitch);
          int wd = 0;
          if (p < positions) {
            const int oi = p / a.tile_w, oc = p - oi * a.tile_w;
            int slot = (t * th + oi * s) % a.ring_rows;
            for (int i_k = 0; i_k < k; ++i_k) {
              const int8_t* rp = xs + slot * row_len;
              for (int j_k = 0, jp = 0, jq = 0; j_k < k; ++j_k) {
                const uint32_t* src = reinterpret_cast<const uint32_t*>(
                    rp + (jp * pc + oc + jq) * a.cin_stride);
                for (int q = 0; q < tap_words; ++q) row[wd++] = src[q];
                if (++jp == s) {
                  jp = 0;
                  ++jq;
                }
              }
              if (++slot == a.ring_rows) slot = 0;
            }
          }
          for (; wd < words; ++wd) row[wd] = 0;
        }
        __syncthreads();
      }

      // this warp's k-steps of the stage.  k-step (st, q) reads A at the
      // cursor, which then advances.  In the one-block-an-SM instance with
      // warps_k == 1 the fragments of k-step q + 1 are loaded before the
      // products of k-step q (the registers of the two-block instance
      // would spill)
      const int8_t* wsb = ws + (gs % kStages) * n_blk * kWPitch;
      auto load = [&](int q, uint32_t (&bf)[4][2], uint32_t (&af)[kMF][4]) {
        ldsm_x4(wsb + b_off + q * kMmaK, bf[0][0], bf[0][1], bf[1][0],
                bf[1][1]);
        ldsm_x4(wsb + b_off + 2 * kMmaN * kWPitch + q * kMmaK, bf[2][0],
                bf[2][1], bf[3][0], bf[3][1]);
        // a 16-channel tail reads its first half twice (zero weights)
        const int koff =
            kIm2col ? (st * kStageSteps + q) * kMmaK
                    : cc * kMmaK - (tail && cc == cpt - 1 ? a_half : 0);
#pragma unroll
        for (int i = 0; i < kMF; ++i)
          if (i < a.m_frags)
            ldsm_x4((kIm2col ? im + a_im[i] : xs + a_off[i]) + koff,
                    af[i][0], af[i][1], af[i][2], af[i][3]);
        if (!kIm2col) {                // advance the cursor
          cc += a.warps_k;
          if (cc >= cpt) {
            do {
              cc -= cpt;
              next_tap();
            } while (cc >= cpt);
            tap_offsets();
          }
        }
      };
      auto products = [&](const uint32_t (&bf)[4][2],
                          const uint32_t (&af)[kMF][4]) {
#pragma unroll
        for (int i = 0; i < kMF; ++i)
          if (i < a.m_frags)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
      };
      const int steps = min(kStageSteps, a.k_steps - st * kStageSteps);
      if (kMinBlocks == 1 && a.warps_k == 1) {
        uint32_t bf[2][4][2], af[2][kMF][4];
        load(0, bf[0], af[0]);
#pragma unroll
        for (int q = 0; q < kStageSteps; ++q) {
          if (q >= steps) break;
          if (q + 1 < steps) load(q + 1, bf[(q + 1) & 1], af[(q + 1) & 1]);
          products(bf[q & 1], af[q & 1]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < kStageSteps; ++q) {
          if (q >= steps) break;
          if ((q & (a.warps_k - 1)) != wk) continue;
          uint32_t bf[4][2], af[kMF][4];
          load(q, bf, af);
          products(bf, af);
        }
      }
    }

    // warps_k > 1: the partial sums of the other k warps through their
    // staging (m_frags == 1 there), added exactly by the wk == 0 warp
    if (a.warps_k > 1) {
      if (wk > 0) {
        int* mine = reinterpret_cast<int*>(my_stg);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            mine[(g + (r >> 1) * 8) * (kWarpN + 4) + j * kMmaN + 2 * tq +
                 (r & 1)] = acc[0][j][r];
      }
      __syncthreads();
      if (wk == 0) {
        for (int kk = 1; kk < a.warps_k; ++kk) {
          const int* other = reinterpret_cast<const int*>(
              stg + (wm * a.warps_n * a.warps_k + kk * a.warps_n + wn) *
                        (kStagingBytes / 4));
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              acc[0][j][r] += other[(g + (r >> 1) * 8) * (kWarpN + 4) +
                                    j * kMmaN + 2 * tq + (r & 1)];
        }
      }
    }
    if (wk != 0) continue;

    // epilogue: dequant in registers, a warp's m16 x 32 through its
    // staging, then whole 16-byte pieces, a position's 128 bytes a
    // quarter warp.  This lane's channels: j * 8 + 2 tq + (0, 1).
    int bq[4][2];
    float sq[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = wn * kWarpN + j * kMmaN + 2 * tq + e;
        const bool ok = co < tl.co_valid;
        bq[j][e] = ok && bias != nullptr ? __ldg(bias + tl.co_base + co) : 0;
        sq[j][e] = ok ? __ldg(scale + tl.co_base + co) : 0.0f;
      }
    // the rows this lane stores: lane / 8 + 4 it of each fragment
    const int c4 = (lane % 8) * 4;
    const int co4 = wn * kWarpN + c4;
    const bool c_ok = co4 < tl.co_valid;
    const bool c_vec = a.vec_y && co4 + 4 <= tl.co_valid;
    int p = (wm * a.m_frags) * kMmaM + lane / 8;
    int s_oi = p / a.tile_w, s_oc = p - s_oi * a.tile_w;
#pragma unroll
    for (int i = 0; i < kMF; ++i) {
      if (i >= a.m_frags) break;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          my_stg[(g + (r >> 1) * 8) * (kWarpN + 4) + j * kMmaN + 2 * tq +
                 (r & 1)] =
              activate(__fmul_rn(__int2float_rn(acc[i][j][r] + bq[j][r & 1]),
                                 sq[j][r & 1]),
                       a.activation);
      __syncwarp();
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int oh = t * a.tile_h_out + s_oi;
        const int ow = tl.band * a.tile_w + s_oc;
        if (c_ok && p < positions && oh < a.h_out && ow < a.w_out) {
          float* yp = y + (((size_t)tl.img * a.h_out + oh) * a.w_out + ow) *
                              a.cout + tl.co_base + co4;
          const float* sp = my_stg + (it * 4 + lane / 8) * (kWarpN + 4) + c4;
          if (c_vec) {
            *reinterpret_cast<float4*>(yp) =
                *reinterpret_cast<const float4*>(sp);
          } else {
            for (int e = 0; e < 4 && co4 + e < tl.co_valid; ++e)
              yp[e] = sp[e];
          }
        }
        p += 4;                        // the next row: 4 positions on
        s_oc += 4;
        while (s_oc >= a.tile_w) {
          s_oc -= a.tile_w;
          ++s_oi;
        }
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// The dp4a route (depthwise, grouped Cin/g < 16): the first design's loop
// ---------------------------------------------------------------------------

template <int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
trim_conv2d_q8_dp4a_kernel(const int8_t* __restrict__ x,
                           const int8_t* __restrict__ wq,
                           const int* __restrict__ bias,
                           const float* __restrict__ scale,
                           float* __restrict__ y, const Q8Args a) {
  extern __shared__ int4 smem4[];
  int8_t* xs = reinterpret_cast<int8_t*>(smem4);
  int* ws = reinterpret_cast<int*>(xs + window_bytes(a));

  const Tile tl = tile_of(a, x);
  const int q4 = a.cin4 / kQuad;              // weight words of one tap
  const int s = a.stride, k = a.k;
  const int th = a.tile_h_out * s;            // fresh input rows per strip
  const int kc = k > s ? k - s : 0;           // rows carried to the next strip
  const int wc = window_cols(a);
  const int tcp = kCout * a.tcx;              // weight row pitch (words)
  constexpr int kStageWords = kChunk / kQuad; // weight rows of one stage
  const bool prefetch = a.ring_rows >= 2 * th + kc;

  const int tid = threadIdx.x;
  const int tx = tid % a.tcx;
  const int ty = tid / a.tcx;
  const int pthreads = kThreads / a.tcx;
  const bool computes = ty < pthreads;
  const int positions = a.tile_h_out * a.tile_w;
  const int cin_chunks = (a.cin4 + kChunk - 1) / kChunk;
  const int n_chunks = k * k * cin_chunks;    // weight stages per strip

  // Weight stage: channel words [q0, q0 + 16) of one tap x the tile's
  // C_out, transposed from the K-major rows (zeros past the valid channels).
  auto copy_weights = [&](int chunk, int stage) {
    const int tap = chunk / cin_chunks;
    const int q0 = (chunk - tap * cin_chunks) * kStageWords;
    const int nq = min(kStageWords, q4 - q0);
    int* dst0 = ws + stage * kStageWords * tcp;
    for (int idx = tid; idx < nq * tcp; idx += kThreads) {
      const int qq = idx / tcp, co = idx - qq * tcp;
      const bool ok = co < tl.co_valid;
      const int8_t* src = ok ? wq + (size_t)(tl.co_base + co) * a.kpad +
                                   tap * a.ctap + (q0 + qq) * kQuad
                             : wq;
      cp_async4(reinterpret_cast<float*>(dst0 + qq * tcp + co),
                reinterpret_cast<const float*>(src), ok);
    }
  };

  // the first window whole, with the first weight stage
  copy_window_rows(a, tl, xs, tl.t_first * th, th + kc, 0, 1, false, false);
  copy_weights(0, 0);
  cp_async_commit();
  int stage = 0;

  for (int t = tl.t_first; t < tl.t_last; ++t) {
    const bool has_next = t + 1 < tl.t_last;
    if (t > tl.t_first && !prefetch) {
      // the fresh rows replace strip t-1's first TH rows: every thread is
      // done with strip t-1
      __syncthreads();
      copy_window_rows(a, tl, xs, t * th + kc, th, 0, 1, false, false);
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
      if (prefetch && has_next)
        copy_window_rows(a, tl, xs, (t + 1) * th + kc, th, c, n_chunks, false,
                         false);
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
      stage ^= 1;
    }

    if (!computes) continue;
#pragma unroll
    for (int m = 0; m < kPositions; ++m) {
      const int p = ty + m * pthreads;
      if (p >= positions) continue;
      const int i = p / a.tile_w, cc = p - i * a.tile_w;
      const int oh = t * a.tile_h_out + i, ow = tl.band * a.tile_w + cc;
      if (oh >= a.h_out || ow >= a.w_out) continue;
      float* yrow = y + (((size_t)tl.img * a.h_out + oh) * a.w_out + ow) *
                            a.cout + tl.co_base;
#pragma unroll
      for (int j = 0; j < kCout; ++j) {
        const int co = kCout * tx + j;
        if (co >= tl.co_valid) continue;
        int v = acc[m][j];
        if (bias != nullptr) v += bias[tl.co_base + co];  // exact int32 add
        const float f = __fmul_rn(__int2float_rn(v), scale[tl.co_base + co]);
        yrow[co] = activate(f, a.activation);
      }
    }
  }
}

template <typename Kernel>
int launch_one(Kernel kernel, const int8_t* x, const int8_t* w,
               const int* bias, const float* scale, float* y,
               const Q8Args& a, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.n * a.groups * a.co_tiles * a.n_bands, a.segments);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, scale, y, a);
  return (int)cudaGetLastError();
}

// The route a shape takes (core/conv_plan.py, q8_route).
int route_of(int cin_pg, int groups, int kpad) {
  if (cin_pg % kVec == 0) return kRouteMma;
  if (groups == 1 && kpad <= kIm2colMaxK) return kRouteIm2col;
  return kRouteDp4a;
}

int launch(const int8_t* x, const int8_t* w, const int* bias,
           const float* scale, float* y, Q8Args a, void* stream) {
  if (a.k < 1 || a.stride < 1 || a.groups < 1 || a.cin % a.groups != 0 ||
      a.cout % a.groups != 0 || a.tile_cout < 1 || a.tile_h_out < 1 ||
      a.tile_w < 1 || a.strips_per_seg < 1 || a.zero_point < -128 ||
      a.zero_point > 127)
    return (int)cudaErrorInvalidValue;
  const int cin_pg = a.cin / a.groups, cout_pg = a.cout / a.groups;
  const int kc = a.k > a.stride ? a.k - a.stride : 0;
  a.cin_pg = cin_pg;
  a.cin4 = (cin_pg + kQuad - 1) / kQuad * kQuad;
  a.ctap = cin_pg % kVec == 0 ? (cin_pg + kMmaK - 1) / kMmaK * kMmaK : a.cin4;
  a.kpad = (a.k * a.k * a.ctap + kMmaK - 1) / kMmaK * kMmaK;
  // a route its own constants do not give is refused: the plan's Q8_*
  // constants and these disagree
  if (a.route != route_of(cin_pg, a.groups, a.kpad))
    return (int)cudaErrorInvalidValue;
  a.tcx = (a.tile_cout + kCout - 1) / kCout;
  a.n_strips = (a.h_out + a.tile_h_out - 1) / a.tile_h_out;
  a.n_bands = (a.w_out + a.tile_w - 1) / a.tile_w;
  a.co_tiles = (cout_pg + a.tile_cout - 1) / a.tile_cout;
  a.segments = (a.n_strips + a.strips_per_seg - 1) / a.strips_per_seg;
  a.word_x = cin_pg % kQuad == 0 && a.cin % kQuad == 0 &&
             (uintptr_t)x % 4 == 0;
  const int positions = a.tile_h_out * a.tile_w;
  if (a.cin_stride < a.cin4 || a.cin_stride % kQuad != 0 ||
      a.ring_rows < a.tile_h_out * a.stride + kc || a.segments > 65535)
    return (int)cudaErrorInvalidValue;
  if (a.route == kRouteDp4a) {
    if (a.tile_cout > 32 * kCout ||
        positions > (kThreads / a.tcx) * kPositions)
      return (int)cudaErrorInvalidValue;
  } else {
    const bool wn_ok = a.warps_n == 1 || a.warps_n == 2 || a.warps_n == 4;
    const bool wk_ok = a.warps_k == 1 || a.warps_k == 2 || a.warps_k == 4;
    if (!wn_ok || !wk_ok || a.warps_n * a.warps_k > kWarps ||
        a.m_frags < 1 || a.m_frags > kMaxMFrags ||
        (a.warps_k > 1 && a.m_frags != 1) ||
        a.tile_cout > kWarpN * a.warps_n || positions > mma_slots(a) ||
        (a.route == kRouteMma && a.cin_stride % kVec != 0) ||
        (uintptr_t)w % 16 != 0)
      return (int)cudaErrorInvalidValue;
    a.vec_x = a.route == kRouteMma && a.cin % kVec == 0 &&
              (uintptr_t)x % 16 == 0;
    a.vec_y = a.cout % 4 == 0 && cout_pg % 4 == 0 && a.tile_cout % 4 == 0 &&
              (uintptr_t)y % 16 == 0;
    a.k_steps = a.kpad / kMmaK;
    a.stages = (a.k_steps + kStageSteps - 1) / kStageSteps;
  }
  const size_t smem = smem_bytes(a);
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  // a block too large for two an SM runs an instance compiled for one (the
  // plan counts resident blocks the same way); more than kMaxMFragsTwo m16
  // fragments a warp need more than 128 registers: one block an SM too
  const bool one = 2 * (smem + kReservedSmem) > (size_t)kSmemPerSm;
  if (a.route == kRouteDp4a)
    return one ? launch_one(trim_conv2d_q8_dp4a_kernel<1>, x, w, bias, scale,
                            y, a, smem, stream)
               : launch_one(trim_conv2d_q8_dp4a_kernel<2>, x, w, bias, scale,
                            y, a, smem, stream);
  const bool wide = a.m_frags > kMaxMFragsTwo;
  if (a.route == kRouteMma)
    return wide ? launch_one(trim_conv2d_q8_mma_kernel<false, kMaxMFrags, 1>,
                             x, w, bias, scale, y, a, smem, stream)
           : one ? launch_one(
                       trim_conv2d_q8_mma_kernel<false, kMaxMFragsTwo, 1>, x,
                       w, bias, scale, y, a, smem, stream)
                 : launch_one(
                       trim_conv2d_q8_mma_kernel<false, kMaxMFragsTwo, 2>, x,
                       w, bias, scale, y, a, smem, stream);
  return wide ? launch_one(trim_conv2d_q8_mma_kernel<true, kMaxMFrags, 1>, x,
                           w, bias, scale, y, a, smem, stream)
         : one ? launch_one(trim_conv2d_q8_mma_kernel<true, kMaxMFragsTwo, 1>,
                            x, w, bias, scale, y, a, smem, stream)
               : launch_one(trim_conv2d_q8_mma_kernel<true, kMaxMFragsTwo, 2>,
                            x, w, bias, scale, y, a, smem, stream);
}

Q8Args make_args(int n, int h, int w, int cin, int cout, int k, int stride,
                 int pad_top, int pad_left, int groups, int h_out, int w_out,
                 int tile_h_out, int tile_w, int tile_cout, int strips_per_seg,
                 int ring_rows, int cin_stride, int zero_point,
                 int activation, int route, int warps_n, int warps_k,
                 int m_frags) {
  Q8Args a = {};
  a.n = n; a.h = h; a.w = w; a.cin = cin; a.cout = cout; a.k = k;
  a.stride = stride; a.pad_top = pad_top; a.pad_left = pad_left;
  a.groups = groups; a.h_out = h_out; a.w_out = w_out;
  a.tile_h_out = tile_h_out; a.tile_w = tile_w; a.tile_cout = tile_cout;
  a.strips_per_seg = strips_per_seg; a.ring_rows = ring_rows;
  a.cin_stride = cin_stride; a.zero_point = zero_point;
  a.activation = activation; a.route = route; a.warps_n = warps_n;
  a.warps_k = warps_k; a.m_frags = m_frags;
  return a;
}

}  // namespace

// C entry points, bound with ctypes by repro_torch/kernels/build.py.  Each
// launches on `stream` without synchronising and returns cudaGetLastError()
// (or cudaErrorInvalidValue for a geometry or route the kernel cannot
// take).  `w` is the packed weight layout above; `bias` may be null;
// strips_per_seg, ring_rows, cin_stride, the route (0 mma, 1 im2col, 2
// dp4a) and the warps (0 on the dp4a route) are ConvPlan's (dtype_bytes=1);
// halo takes one strip a segment and the plain window ring whatever it is
// given.
extern "C" {

#define TRIM_CONV2D_Q8_ARGS                                                   \
  const int8_t *x, const int8_t *w, const int *bias, const float *scale,      \
      float *y, int n, int h, int wd, int cin, int cout, int k, int stride,   \
      int pad_top, int pad_left, int groups, int h_out, int w_out,            \
      int tile_h_out, int tile_w, int tile_cout, int strips_per_seg,          \
      int ring_rows, int cin_stride, int zero_point, int activation,          \
      int route, int warps_n, int warps_k, int m_frags, void *stream

int trim_conv2d_q8_carry(TRIM_CONV2D_Q8_ARGS) {
  return launch(x, w, bias, scale, y,
                make_args(n, h, wd, cin, cout, k, stride, pad_top, pad_left,
                          groups, h_out, w_out, tile_h_out, tile_w, tile_cout,
                          strips_per_seg, ring_rows, cin_stride, zero_point,
                          activation, route, warps_n, warps_k, m_frags),
                stream);
}

int trim_conv2d_q8_halo(TRIM_CONV2D_Q8_ARGS) {
  const int kc = k > stride ? k - stride : 0;
  return launch(x, w, bias, scale, y,
                make_args(n, h, wd, cin, cout, k, stride, pad_top, pad_left,
                          groups, h_out, w_out, tile_h_out, tile_w, tile_cout,
                          1, tile_h_out * stride + kc, cin_stride, zero_point,
                          activation, route, warps_n, warps_k, m_frags),
                stream);
}

const char* trim_conv2d_q8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
