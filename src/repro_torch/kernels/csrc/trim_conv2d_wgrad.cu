// Weight gradient of the 3D-TrIM convolution for NVIDIA Hopper (sm_90a),
// f32 and bf16 operands, hand-written CUDA.
//
// Replaces the TPU Pallas kernel _weight_grad_kernel of
// src/repro/kernels/trim_conv2d.py (:429; pallas_call :529), on f32 and on
// bf16 operands.
//
// Math.  dw[ki,kj,ci,g*Cpg+co] = sum_{n,oh,ow} xpad[n, oh*s+ki, ow*s+kj,
// g*Cin_pg+ci] * dz[n,oh,ow,g*Cpg+co], ki < KH, kj < KW (a square kernel
// or a rectangular sub-kernel of the kernel tiling).  Per group, dw is a
// (KH*KW*Cin_pg) x Cpg matrix whose rows are the flattened (ki, kj, ci)
// axis: the product
// of the im2col'd input (positions x rows) and the cotangent (positions x
// Cpg) over the positions, formed on the fly.  'same'/'valid' padding is
// virtual: the loader zero-fills outside the image, so no padded copy of x
// exists.
//
// What bounds it on the H100.  At VGG-16 shapes the weight gradient does
// as many FLOPs as the forward conv on as many bytes, hundreds of FLOPs per
// byte, so the bound is operations: 67 TFLOP/s of f32 FFMA for f32
// operands, 989 TFLOP/s of the bf16 tensor cores for bf16 ones.  The f32
// entry stays on the FFMA pipes (no TF32, no tensor cores), so its result
// stays one fmaf chain per element; the bf16 entry's route "mma" (below)
// runs on the bf16 tensor cores.
//
// Chunks (core/conv_plan.py WeightGradPlan).  The TPU kernel sweeps
// (image, strip of cotangent rows) in sequence into one resident f32
// block.  Blocks here run in parallel and in no order, so the sweep is cut
// into chunks of tile_go consecutive rows of the flattened (n, oh) axis,
// as tall as a full round of resident blocks on the 132 SMs allows (a
// model of the time in the plan: VGG-16 conv2 at batch 8 is 52 chunks and
// 7.7 MB of partials, down from 896 chunks and 132 MB in the first
// design of 256-position chunks).
//
// GEMM route (wgrad_gemm_kernel).  A block owns (chunk, group, 128-row
// tile, 128- or 64-column tile; 64 where Cout/g <= 64).  256 threads as
// 16 x 16, each with an 8 x 8 (or 8 x 4) register tile of accumulators:
// rows 4 ty + {0..3} and 64 + 4 ty + {0..3}, columns 4 tx + 64 c + {0..3},
// so a position costs a thread 64 FMAs per four LDS.128 (the first design:
// 16 per two).  Positions arrive 16 a stage in a 3-stage shared-memory
// ring filled by cp.async with zero-fill at the virtual pad and past the
// chunk: stage s + 2 is copied while stage s computes, one barrier a
// stage.  NHWC keeps both operands contiguous along their channel axis,
// so a thread copies 16 bytes along ci for a fixed tap and along co.
// Where Cin/g or Cout/g is not a multiple of 4 (or the operand is not
// 16-byte aligned) that operand's loader copies 4 bytes at a time: a
// template instance of the same kernel, not a fallback.
//
// bf16 operands (trim_conv2d_wgrad_bf16).  JAX's kernel takes bf16 x and
// cotangent, sums their products in f32 (preferred_element_type) into an
// f32 block and casts dw to bf16 once.  The entry writes f32 dw; autograd
// rounds it once to bf16.  Two routes (core/conv_plan.py, wgrad_route):
//
// Route "mma" (wgrad_mma_kernel): Cin/g a multiple of 16, Cout/g of 8,
// both operands 16-byte aligned (the wrapper copies one that is not):
// VGG-16 conv2-13, AlexNet conv2-5, ResNet-18 and U-Net past their stems.
// Per group dw is M = (ki, kj, ci) rows by N = co columns, and the k axis
// is the chunk's cotangent positions (n, oh, ow).  A block owns 128 rows x
// 128 (or 64) columns of one chunk: 8 warps of 2 x 4 (or 4 x 2), each
// 4 (or 2) m16 x 4 n8 fragments of mma.sync.m16n8k16 bf16 -> f32.  x and
// the cotangent stay bf16 in shared memory, position-major ([position]
// [row], [position][column]), 64 positions a stage in a 3-stage ring
// filled by 16-byte cp.async (8 channels, one tap: Cin/g % 16 == 0), zeros
// at the virtual pad, past the chunk and past the tile; rows are padded to
// an odd count of 16-byte quads (128 + 8 bf16: 17 quads; 64 + 8: 9), so
// no ldmatrix phase has a bank conflict.  Both operands come through
// ldmatrix.x4.trans: A = x^T (16 rows x 16 positions) by ldsm_x4_trans_a,
// B = dz (16 positions x 8 columns) by ldsm_x4_trans, as the forward's B.
// Taps: each 8-row group of a staged row is copied with its own tap's
// offset, so x is re-staged for every tap a tile holds.  A stride-1 shift
// of one staged strip would serve several taps, but the k axis runs over
// flattened (n, oh, ow), so a shifted 16-position k-step crosses row ends
// and the pad at other positions for every tap, and a k-step would need
// a per-tap map from positions to strip rows; the re-staged copies come
// from L2 and the tensor cores, not the copies, are what the loop waits
// on.  Order contract, route mma: each partial-dw element
//
//   acc = 0.0f                                  (one f32 accumulator)
//   for p0 = 0, 16, 32, ... < the chunk's positions, ascending (n, oh, ow):
//     acc = mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32(A, B, acc)
//           (k lane l of the step is position p0 + l, l = 0..15; positions
//           past the chunk are zeros in both operands and add exact zeros)
//
// then the partials are summed in ascending chunk order by
// wgrad_reduce_kernel (one fadd chain).  Nothing else enters a sum: no
// split of the k axis across warps or blocks, no atomics, so two launches
// are bitwise equal.  A chunk's chain (tile_go x W_out positions, e.g. 490
// k-steps at VGG-16 conv2, N=8) goes into one tensor-core accumulator,
// which truncates as it adds (flash_attention.cu, "Truncation"): at most
// ~2^-23 of its running sum a k-step, within the bound chip_smoke.py holds
// it to, (positions a chunk + chunks) 2^-22 sum|x dz|, so no chain is
// broken into fresh accumulators.  The plain version is the f32 einsum,
// which the tensor core's sum does not repeat bit for bit: the card holds
// this route to a float64 oracle.
//
// Route "gemm" (the other bf16 layers: Cin 3, other grouped layers) and
// "depthwise": the f32 kernels' template on bf16.  The loaders widen each
// bf16 value to f32 on its way into the same f32 shared-memory stages,
// and the FFMA loop, the tiles, the chunks and the ordered reduction are
// the f32 kernel's.  A bf16 x bf16 product is exact in f32, so these
// routes' f32 dw is bitwise the f32 entry's on the widened operands under
// the same plan.  cp.async cannot widen and has no 2-byte copy (a bf16
// pixel of Cin 3 is 6 bytes, so half of VGG-16 conv1's pixels do not start
// on a 4-byte boundary), so these loaders load through registers: 16 bytes
// (8 bf16) a thread where Cin/g (Cout/g) is a multiple of 8 and the
// operand 16-byte aligned, else one element a thread, again instances of
// one kernel.  The loads of stage s + 2 are issued before stage s computes
// and land in shared memory before the next barrier; the other resident
// warps hide their latency.
//
// Depthwise route (wgrad_depthwise_kernel, groups == Cin == Cout).  A GEMM
// tile would use 9 rows and 1 column a group.  Here a thread owns one
// (tap, channel) element, lanes along the channels, so each position's
// loads of x and the cotangent are coalesced; the same chunks and the same
// ordered reduction apply.  bf16 widens at the load.
//
// Determinism without float atomics.  The partial launch writes one
// partial dw per chunk into a workspace: each element is ONE fmaf chain
// (route mma: one tensor-core chain, above) over the chunk's positions in
// ascending (n, oh, ow) order.
// wgrad_reduce_kernel sums the partials of each element in ascending chunk
// order, one fadd chain (float4 where dw's size allows).  The result
// depends on the shape and the data only, so two launches on the same
// inputs are bitwise equal.  With a single chunk the partial launch writes
// dw itself and the reduction is skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_mma.cuh"
#include "cp_async.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;     // threads per block
constexpr int kTileRows = 128;    // rows of the flattened (ki, kj, ci) axis
constexpr int kPositions = 16;    // cotangent positions a stage
constexpr int kStages = 3;        // stages of the cp.async ring

// route mma (kBf16* of bf16_mma.cuh)
constexpr int kMmaTileRows = 128;    // rows a block
constexpr int kMmaPositions = 64;    // cotangent positions a stage: 4 k-steps
constexpr int kMmaStages = 3;        // stages of its cp.async ring
constexpr int kMmaBlocksPerSm = 2;   // __launch_bounds__(kThreads, 2)
constexpr int kMmaXPitch = kMmaTileRows + kBf16RowPad;   // bf16 a staged x
                                                         // row: 17 quads

static_assert(kThreads == 16 * 16 && kTileRows == 16 * 8,
              "a 16 x 16 thread grid of 8-row accumulator tiles");
static_assert(kMmaTileRows == kTileRows, "both GEMM routes tile rows alike");

// The routes (core/conv_plan.py WGRAD_ROUTES, in order): the plan's, passed
// by the wrapper and checked by the launcher against the layer.
enum WgradRoute { kRouteGemm = 0, kRouteDepthwise = 1, kRouteMma = 2 };

struct WgradArgs {
  int n, h, w, cin, cout, kh, kw, stride, pad_top, pad_left, groups;
  int h_out, w_out;
  int tile_go;     // cotangent rows per chunk
  int chunks;
  int rows;        // KH * KW * Cin/groups
  int cin_pg, cout_pg;
  int row_tiles, co_tiles;
};

template <int kTileCout>
constexpr size_t gemm_smem_bytes() {
  return (size_t)kStages * kPositions * (kTileRows + kTileCout) *
         sizeof(float);
}

// A bf16 value widened to f32, exactly: its 16 bits are the f32's high
// half.
__device__ __forceinline__ float widen(unsigned u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const bf16* p) {
  return widen(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// Eight bf16 at `src` (16-byte aligned) widened into dst[0..7] (shared,
// 32-byte aligned), or eight zeros where !ok.  Element 2i is the low half
// of word i.
__device__ __forceinline__ void load8_widen(float* dst, const bf16* src,
                                            bool ok) {
  const uint4 u = ok ? __ldg(reinterpret_cast<const uint4*>(src))
                     : make_uint4(0u, 0u, 0u, 0u);
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(widen(u.x), __uint_as_float(u.x & 0xffff0000u),
                     widen(u.y), __uint_as_float(u.y & 0xffff0000u));
  d[1] = make_float4(widen(u.z), __uint_as_float(u.z & 0xffff0000u),
                     widen(u.w), __uint_as_float(u.w & 0xffff0000u));
}

// (image, oh, ow) of a cotangent position moved `by` positions along the
// flattened (n, oh, ow) axis.
__device__ __forceinline__ void advance(int& img, int& oh, int& ow, int by,
                                        const WgradArgs& a) {
  ow += by;
  while (ow >= a.w_out) {
    ow -= a.w_out;
    if (++oh == a.h_out) {
      oh = 0;
      ++img;
    }
  }
}

// The bf16 stage loader: stage(xdst, gdst, q0, npos) fills one stage of
// the ring (positions q0 .. q0 + 15 of the chunk) in the layout the
// compute loop reads: x as [position][row], the cotangent as
// [position][column], f32, zeros at the virtual pad, past the chunk and
// past the tile.  f32 operands need none: the kernel's own cp.async
// loaders copy them (the primary template is empty).
template <typename T, int kTileCout, bool kVecX, bool kVecG>
struct Bf16Loader {
  template <typename... Args>
  __device__ __forceinline__ explicit Bf16Loader(const Args&...) {}
};

// bf16: loads through registers, widened and stored as f32.  kVecX /
// kVecG: 8 bf16 (16 bytes) a thread, eight rows of one tap (Cin/g % 8
// == 0) or eight columns; else one element a thread.
template <int kTileCout, bool kVecX, bool kVecG>
struct Bf16Loader<bf16, kTileCout, kVecX, kVecG> {
  static constexpr int kXV = kVecX ? 8 : 1;             // elements a load
  static constexpr int kXThreads = kTileRows / kXV;     // a position
  static constexpr int kXLanes = kThreads / kXThreads;  // positions at once
  static constexpr int kXPasses = kPositions / kXLanes;
  static constexpr int kGV = kVecG ? 8 : 1;
  static constexpr int kGThreads = kTileCout / kGV;
  static constexpr int kGLanes = kThreads / kGThreads;
  static constexpr int kGPasses = (kPositions + kGLanes - 1) / kGLanes;
  static_assert(kXPasses >= 1 && kXLanes * kXPasses == kPositions &&
                    kGThreads * kGLanes == kThreads,
                "loader geometry");

  const bf16* x;
  const bf16* gsrc;
  int xc, xp, gc, gp, gco;
  int xki, xkj;
  long long xoff;
  // (image, oh, ow) of the x loader's first position of the next stage
  int pimg, poh, pow_;

  __device__ __forceinline__ Bf16Loader(const bf16* x_, const bf16* g,
                                         const WgradArgs& a, int rt, int grp,
                                         int cot, int row0, int tid)
      : x(x_) {
    // x loader: rows kXV xc .. kXV xc + kXV - 1 of the tile (one tap),
    // positions xp + kXLanes i
    xc = tid % kXThreads;
    xp = tid / kXThreads;
    const int r = rt * kTileRows + kXV * xc;
    xki = -(1 << 20);          // a row past the tile's end: never in range
    xkj = 0;
    xoff = 0;
    if (r < a.rows) {
      const int tap = r / a.cin_pg, ci = r - tap * a.cin_pg;
      xki = tap / a.kw;
      xkj = tap - xki * a.kw;
      xoff = ((long long)xki * a.w + xkj) * a.cin + grp * a.cin_pg + ci;
    }
    const int orow = row0 + xp / a.w_out;
    pow_ = xp - (xp / a.w_out) * a.w_out;
    pimg = orow / a.h_out;
    poh = orow - pimg * a.h_out;
    // cotangent loader: columns kGV gc .., positions gp + kGLanes i
    gc = tid % kGThreads;
    gp = tid / kGThreads;
    gco = cot * kTileCout + kGV * gc;
    gsrc = g + (long long)row0 * a.w_out * a.cout + grp * a.cout_pg + gco;
  }

  __device__ __forceinline__ void stage(float* xdst, float* gdst, int q0,
                                        int npos, const WgradArgs& a) {
    int img = pimg, oh = poh, ow = pow_;
#pragma unroll
    for (int i = 0; i < kXPasses; ++i) {
      const int p = xp + kXLanes * i;
      const int ih0 = oh * a.stride - a.pad_top;
      const int iw0 = ow * a.stride - a.pad_left;
      const int ih = ih0 + xki, iw = iw0 + xkj;
      const bool ok = q0 + p < npos && ih >= 0 && ih < a.h && iw >= 0 &&
                      iw < a.w;
      const bf16* src =
          x + (((long long)img * a.h + ih0) * a.w + iw0) * a.cin + xoff;
      float* dst = xdst + p * kTileRows + kXV * xc;
      if (kVecX)
        load8_widen(dst, src, ok);
      else
        *dst = ok ? ldg_f32(src) : 0.0f;
      if (i + 1 < kXPasses) advance(img, oh, ow, kXLanes, a);
    }
    advance(pimg, poh, pow_, kPositions, a);
#pragma unroll
    for (int i = 0; i < kGPasses; ++i) {
      const int p = gp + kGLanes * i;
      if (kGLanes > kPositions && p >= kPositions) break;
      const bool ok = q0 + p < npos && gco < a.cout_pg;
      const bf16* src = gsrc + (long long)(q0 + p) * a.cout;
      float* dst = gdst + p * kTileCout + kGV * gc;
      if (kVecG)
        load8_widen(dst, src, ok);
      else
        *dst = ok ? ldg_f32(src) : 0.0f;
    }
  }
};

// T: float or bf16 x and cotangent; the partials (out) are f32 either way.
// kVecX / kVecG pick the loaders' vector or scalar instance.
template <typename T, int kTileCout, bool kVecX, bool kVecG>
__global__ void __launch_bounds__(kThreads, 2)
wgrad_gemm_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  float* __restrict__ out, const WgradArgs a) {
  constexpr int kCw = kTileCout / 64;          // float4 column groups
  constexpr int kXStage = kPositions * kTileRows;
  constexpr int kGStage = kPositions * kTileCout;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [stage][position][row]
  float* gs = xs + kStages * kXStage;            // [stage][position][col]

  int b = blockIdx.x;
  const int cot = b % a.co_tiles; b /= a.co_tiles;
  const int rt = b % a.row_tiles; b /= a.row_tiles;
  const int grp = b % a.groups;
  const int chunk = b / a.groups;
  const int tid = threadIdx.x;

  const int total_rows = a.n * a.h_out;
  const int row0 = chunk * a.tile_go;
  const int row1 = min(total_rows, row0 + a.tile_go);
  const int npos = (row1 - row0) * a.w_out;
  const int nstages = (npos + kPositions - 1) / kPositions;

  // f32: cp.async straight into the stage, inline (behind a loader
  // struct like the bf16 one the f32 entry ran 2.4% slower on the H100).
  // x loader: rows 4 xc .. 4 xc + 3 of the tile, positions xp + 8 i.  The
  // vector path's four rows share one tap (Cin/g % 4 == 0), so only row
  // 0's tap is kept.  bf16 operands leave this state unused.
  constexpr int kGCols4 = kTileCout / 4;       // float4s a staged row
  constexpr int kGLanes = kThreads / kGCols4;  // positions copied at once
  constexpr int kGPasses = kPositions / kGLanes;
  constexpr int kXLanes = kThreads / (kTileRows / 4);
  constexpr int kXPasses = kPositions / kXLanes;
  static_assert(kGPasses >= 1 && kXPasses == 2, "loader geometry");
  constexpr int kXRows = kVecX ? 1 : 4;
  const int xc = tid % (kTileRows / 4), xp = tid / (kTileRows / 4);
  int xki[kXRows], xkj[kXRows];
  long long xoff[kXRows];
#pragma unroll
  for (int j = 0; j < kXRows; ++j) {
    const int r = rt * kTileRows + 4 * xc + j;
    xki[j] = -(1 << 20);     // a row past the tile's end: never in range
    xkj[j] = 0;
    xoff[j] = 0;
    if (r < a.rows) {
      const int tap = r / a.cin_pg, ci = r - tap * a.cin_pg;
      xki[j] = tap / a.kw;
      xkj[j] = tap - xki[j] * a.kw;
      xoff[j] = ((long long)xki[j] * a.w + xkj[j]) * a.cin +
                grp * a.cin_pg + ci;
    }
  }
  // (image, oh, ow) of the x loader's two positions, advanced a stage at a
  // time
  int pimg[kXPasses], poh[kXPasses], pow_[kXPasses];
#pragma unroll
  for (int i = 0; i < kXPasses; ++i) {
    const int q = xp + kXLanes * i;
    const int orow = row0 + q / a.w_out;
    pow_[i] = q - (q / a.w_out) * a.w_out;
    pimg[i] = orow / a.h_out;
    poh[i] = orow - pimg[i] * a.h_out;
  }
  // cotangent loader: columns 4 gc .. 4 gc + 3, positions gp + kGLanes i
  const int gc = tid % kGCols4, gp = tid / kGCols4;
  const int gco = cot * kTileCout + 4 * gc;
  const T* gsrc = g + (long long)row0 * a.w_out * a.cout +
                  grp * a.cout_pg + gco;
  Bf16Loader<T, kTileCout, kVecX, kVecG> bf16_loader(x, g, a, rt, grp, cot,
                                                     row0, tid);

  auto load = [&](int stage, int buf) {
    const int q0 = stage * kPositions;
    float* xdst = xs + buf * kXStage;
    float* gdst = gs + buf * kGStage;
    if constexpr (!std::is_same<T, float>::value) {
      bf16_loader.stage(xdst, gdst, q0, npos, a);
    } else {
#pragma unroll
      for (int i = 0; i < kXPasses; ++i) {
        const int p = xp + kXLanes * i;
        const bool pos_ok = q0 + p < npos;
        const int ih0 = poh[i] * a.stride - a.pad_top;
        const int iw0 = pow_[i] * a.stride - a.pad_left;
        const long long base =
            (((long long)pimg[i] * a.h + ih0) * a.w + iw0) * a.cin;
        float* dst = xdst + p * kTileRows + 4 * xc;
#pragma unroll
        for (int j = 0; j < kXRows; ++j) {
          const int ih = ih0 + xki[j], iw = iw0 + xkj[j];
          const bool ok = pos_ok && ih >= 0 && ih < a.h && iw >= 0 &&
                          iw < a.w;
          const float* src = ok ? x + base + xoff[j] : x;
          if (kVecX)
            cp_async16(dst, src, ok);
          else
            cp_async4(dst + j, src, ok);
        }
        advance(pimg[i], poh[i], pow_[i], kPositions, a);
      }
#pragma unroll
      for (int i = 0; i < kGPasses; ++i) {
        const int p = gp + kGLanes * i;
        const bool pos_ok = q0 + p < npos;
        const float* src = gsrc + (long long)(q0 + p) * a.cout;
        float* dst = gdst + p * kTileCout + 4 * gc;
        if (kVecG) {
          const bool ok = pos_ok && gco < a.cout_pg;
          cp_async16(dst, ok ? src : g, ok);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool ok = pos_ok && gco + j < a.cout_pg;
            cp_async4(dst + j, ok ? src + j : g, ok);
          }
        }
      }
    }
  };

  const int ty = tid / 16, tx = tid % 16;
  float acc[8][4 * kCw];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kCw; ++j) acc[i][j] = 0.0f;

  auto step = [&](const float* xb, const float* gb, int p) {
    const float4 x0 = *reinterpret_cast<const float4*>(
        xb + p * kTileRows + 4 * ty);
    const float4 x1 = *reinterpret_cast<const float4*>(
        xb + p * kTileRows + 64 + 4 * ty);
    const float xr[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    float gr[4 * kCw];
#pragma unroll
    for (int c = 0; c < kCw; ++c) {
      const float4 gv = *reinterpret_cast<const float4*>(
          gb + p * kTileCout + 64 * c + 4 * tx);
      gr[4 * c] = gv.x;
      gr[4 * c + 1] = gv.y;
      gr[4 * c + 2] = gv.z;
      gr[4 * c + 3] = gv.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4 * kCw; ++j)
        acc[i][j] = fmaf(xr[i], gr[j], acc[i][j]);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nstages) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < nstages; ++s) {
    cp_async_wait<kStages - 2>();   // this thread's copies of stage s
    __syncthreads();                // everyone's; stage s-1 is consumed
    if (s + kStages - 1 < nstages)
      load(s + kStages - 1, (s + kStages - 1) % kStages);
    cp_async_commit();
    const float* xb = xs + (s % kStages) * kXStage;
    const float* gb = gs + (s % kStages) * kGStage;
    const int np = npos - s * kPositions;
    if (np >= kPositions) {
#pragma unroll
      for (int p = 0; p < kPositions; ++p) step(xb, gb, p);
    } else {
#pragma unroll 1
      for (int p = 0; p < np; ++p) step(xb, gb, p);
    }
  }

  float* dst = out + (size_t)chunk * a.rows * a.cout + grp * a.cout_pg;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = rt * kTileRows + 4 * ty + (i & 3) + (i >> 2) * 64;
    if (row >= a.rows) continue;
#pragma unroll
    for (int c = 0; c < kCw; ++c) {
      const int col = cot * kTileCout + 64 * c + 4 * tx;
      float* o = dst + (size_t)row * a.cout + col;
      if (kVecG) {
        if (col < a.cout_pg)
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[i][4 * c], acc[i][4 * c + 1],
                          acc[i][4 * c + 2], acc[i][4 * c + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < a.cout_pg) o[j] = acc[i][4 * c + j];
      }
    }
  }
}

template <int kTileCout>
constexpr size_t mma_smem_bytes() {
  return (size_t)kMmaStages * kMmaPositions *
         (kMmaXPitch + kTileCout + kBf16RowPad) * sizeof(bf16);
}

// Route mma (see the notes at the top): a block owns (chunk, group,
// 128-row tile, kTileCout-column tile); warp w owns rows wm * 16 kMF ..
// and columns wn * 32 .. of it, kMF m16 x 4 n8 accumulator fragments.
template <int kTileCout>
__global__ void __launch_bounds__(kThreads, kMmaBlocksPerSm)
wgrad_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                 float* __restrict__ out, const WgradArgs a) {
  constexpr int kWarpsN = kTileCout / kBf16WarpN;        // 4 or 2
  constexpr int kWarpsM = kThreads / 32 / kWarpsN;       // 2 or 4
  constexpr int kMF = kMmaTileRows / (kBf16MmaM * kWarpsM);   // 4 or 2
  constexpr int kGPitch = kTileCout + kBf16RowPad;       // 17 or 9 quads
  constexpr int kXStage = kMmaPositions * kMmaXPitch;
  constexpr int kGStage = kMmaPositions * kGPitch;
  constexpr int kSteps = kMmaPositions / kBf16MmaK;      // k-steps a stage
  // loaders: 16-byte copies of 8 rows (x) or 8 columns (cotangent)
  constexpr int kXGroups = kMmaTileRows / 8;             // 16 a position
  constexpr int kXLanes = kThreads / kXGroups;           // positions at once
  constexpr int kXPasses = kMmaPositions / kXLanes;      // 4
  constexpr int kGGroups = kTileCout / 8;                // 16 or 8
  constexpr int kGLanes = kThreads / kGGroups;           // 16 or 32
  constexpr int kGPasses = kMmaPositions / kGLanes;      // 4 or 2
  static_assert(kMF * kBf16MmaM * kWarpsM == kMmaTileRows &&
                    kXPasses * kXLanes == kMmaPositions &&
                    kGPasses * kGLanes == kMmaPositions,
                "mma route geometry");
  extern __shared__ float4 smem4[];
  bf16* xs = reinterpret_cast<bf16*>(smem4);      // [stage][position][row]
  bf16* gs = xs + kMmaStages * kXStage;           // [stage][position][col]

  int b = blockIdx.x;
  const int cot = b % a.co_tiles; b /= a.co_tiles;
  const int rt = b % a.row_tiles; b /= a.row_tiles;
  const int grp = b % a.groups;
  const int chunk = b / a.groups;
  const int tid = threadIdx.x;

  const int total_rows = a.n * a.h_out;
  const int row0 = chunk * a.tile_go;
  const int row1 = min(total_rows, row0 + a.tile_go);
  const int npos = (row1 - row0) * a.w_out;
  const int nstages = (npos + kMmaPositions - 1) / kMmaPositions;

  // x loader: rows 8 xc .. 8 xc + 7 of the tile (one tap: Cin/g % 16 ==
  // 0), positions xp + kXLanes i
  const int xc = tid % kXGroups, xp = tid / kXGroups;
  int xki = -(1 << 20), xkj = 0;   // a row past the tile's end: never in
  long long xoff = 0;              // range
  {
    const int r = rt * kMmaTileRows + 8 * xc;
    if (r < a.rows) {
      const int tap = r / a.cin_pg, ci = r - tap * a.cin_pg;
      xki = tap / a.kw;
      xkj = tap - xki * a.kw;
      xoff = ((long long)xki * a.w + xkj) * a.cin + grp * a.cin_pg + ci;
    }
  }
  int pimg[kXPasses], poh[kXPasses], pow_[kXPasses];
#pragma unroll
  for (int i = 0; i < kXPasses; ++i) {
    const int q = xp + kXLanes * i;
    const int orow = row0 + q / a.w_out;
    pow_[i] = q - (q / a.w_out) * a.w_out;
    pimg[i] = orow / a.h_out;
    poh[i] = orow - pimg[i] * a.h_out;
  }
  // cotangent loader: columns 8 gc .. 8 gc + 7, positions gp + kGLanes i
  const int gc = tid % kGGroups, gp = tid / kGGroups;
  const int gco = cot * kTileCout + 8 * gc;
  const bf16* gsrc = g + (long long)row0 * a.w_out * a.cout +
                     grp * a.cout_pg + gco;

  auto load = [&](int stage, int buf) {
    const int q0 = stage * kMmaPositions;
    bf16* xdst = xs + buf * kXStage + 8 * xc;
    bf16* gdst = gs + buf * kGStage + 8 * gc;
#pragma unroll
    for (int i = 0; i < kXPasses; ++i) {
      const int p = xp + kXLanes * i;
      const int ih0 = poh[i] * a.stride - a.pad_top;
      const int iw0 = pow_[i] * a.stride - a.pad_left;
      const int ih = ih0 + xki, iw = iw0 + xkj;
      const bool ok = q0 + p < npos && ih >= 0 && ih < a.h && iw >= 0 &&
                      iw < a.w;
      const bf16* src =
          ok ? x + (((long long)pimg[i] * a.h + ih0) * a.w + iw0) * a.cin +
                   xoff
             : x;
      cp_async16(reinterpret_cast<float*>(xdst + p * kMmaXPitch),
                 reinterpret_cast<const float*>(src), ok);
      advance(pimg[i], poh[i], pow_[i], kMmaPositions, a);
    }
#pragma unroll
    for (int i = 0; i < kGPasses; ++i) {
      const int p = gp + kGLanes * i;
      const bool ok = q0 + p < npos && gco < a.cout_pg;
      const bf16* src = ok ? gsrc + (long long)(q0 + p) * a.cout : g;
      cp_async16(reinterpret_cast<float*>(gdst + p * kGPitch),
                 reinterpret_cast<const float*>(src), ok);
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int m_base = wm * kMF * kBf16MmaM;         // the warp's first row
  const int n_base = wn * kBf16WarpN;              // ... and column
  // a warp whose rows all lie past dw's has nothing to add (warp-uniform)
  const bool live = rt * kMmaTileRows + m_base < a.rows;
  // ldmatrix lane addresses (bf16_mma.cuh): A from position rows
  // (l & 7) + 8 (l >> 4), row columns 8 ((l >> 3) & 1) on; B from position
  // rows (l & 7) + 8 ((l >> 3) & 1), columns 8 (l >> 4) on
  const int a_off = ((lane & 7) + 8 * (lane >> 4)) * kMmaXPitch + m_base +
                    8 * ((lane >> 3) & 1);
  const int b_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * kGPitch +
                    n_base + 8 * (lane >> 4);

  float acc[kMF][4][4];
#pragma unroll
  for (int i = 0; i < kMF; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < nstages) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < nstages; ++s) {
    cp_async_wait<kMmaStages - 2>();   // this thread's copies of stage s
    __syncthreads();                   // everyone's; stage s-1 is consumed
    if (s + kMmaStages - 1 < nstages)
      load(s + kMmaStages - 1, (s + kMmaStages - 1) % kMmaStages);
    cp_async_commit();
    if (!live) continue;
    const bf16* xb = xs + (s % kMmaStages) * kXStage + a_off;
    const bf16* gb = gs + (s % kMmaStages) * kGStage + b_off;
    // k-steps of this stage: the chunk's tail adds zeros past its end
    const int steps = min(kSteps, (npos - s * kMmaPositions +
                                   kBf16MmaK - 1) / kBf16MmaK);
#pragma unroll
    for (int q = 0; q < kSteps; ++q) {
      if (q >= steps) break;
      uint32_t af[kMF][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < kMF; ++i)
        ldsm_x4_trans_a(xb + q * kBf16MmaK * kMmaXPitch + i * kBf16MmaM,
                        af[i]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldsm_x4_trans(gb + q * kBf16MmaK * kGPitch + 16 * j, bfr[2 * j],
                      bfr[2 * j + 1]);
#pragma unroll
      for (int i = 0; i < kMF; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
  }

  // C fragment (g, 2t / 2t + 1) and (g + 8, ..): rows and column pairs
  float* dst = out + (size_t)chunk * a.rows * a.cout + grp * a.cout_pg;
  const int fg = lane / 4, ft = lane % 4;
#pragma unroll
  for (int i = 0; i < kMF; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rt * kMmaTileRows + m_base + kBf16MmaM * i + fg + 8 * h;
      if (row >= a.rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = cot * kTileCout + n_base + kBf16MmaN * j + 2 * ft;
        if (col < a.cout_pg)   // Cout/g % 8 == 0: col + 1 is in range too
          *reinterpret_cast<float2*>(dst + (size_t)row * a.cout + col) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// groups == Cin == Cout: thread e owns dw element e = tap * C + c.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wgrad_depthwise_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       float* __restrict__ out, const WgradArgs a) {
  const int c_all = a.cin;
  const int elems = a.kh * a.kw * c_all;
  const int tiles = (elems + kThreads - 1) / kThreads;
  const int chunk = blockIdx.x / tiles;
  const int e = (blockIdx.x - chunk * tiles) * kThreads + threadIdx.x;
  if (e >= elems) return;
  const int tap = e / c_all, c = e - tap * c_all;
  const int ki = tap / a.kw, kj = tap - ki * a.kw;
  const int row0 = chunk * a.tile_go;
  const int row1 = min(a.n * a.h_out, row0 + a.tile_go);
  float acc = 0.0f;
  for (int orow = row0; orow < row1; ++orow) {
    const int img = orow / a.h_out, oh = orow - img * a.h_out;
    const int ih = oh * a.stride + ki - a.pad_top;
    const bool row_ok = ih >= 0 && ih < a.h;
    const T* xrow =
        x + ((long long)img * a.h + (row_ok ? ih : 0)) * a.w * c_all + c;
    const T* grow = g + (long long)orow * a.w_out * c_all + c;
#pragma unroll 4
    for (int ow = 0; ow < a.w_out; ++ow) {
      const int iw = ow * a.stride + kj - a.pad_left;
      const bool ok = row_ok && iw >= 0 && iw < a.w;
      const float xv = ok ? ldg_f32(xrow + (long long)iw * c_all) : 0.0f;
      acc = fmaf(xv, ldg_f32(grow + (long long)ow * c_all), acc);
    }
  }
  out[(size_t)chunk * elems + e] = acc;
}

// dw[e] = ws[0][e] + ws[1][e] + ... in ascending chunk order.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
wgrad_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                    size_t elems, int chunks) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (kVec) {
    const size_t n4 = elems / 4;
    if (e >= n4) return;
    const float4* w4 = reinterpret_cast<const float4*>(ws);
    float4 s = w4[e];
#pragma unroll 8
    for (int c = 1; c < chunks; ++c) {
      const float4 t = w4[(size_t)c * n4 + e];
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    reinterpret_cast<float4*>(dw)[e] = s;
  } else {
    if (e >= elems) return;
    float s = ws[e];
#pragma unroll 8
    for (int c = 1; c < chunks; ++c) s += ws[(size_t)c * elems + e];
    dw[e] = s;
  }
}

template <typename T, int kTileCout, bool kVecX, bool kVecG>
cudaError_t launch_gemm(const T* x, const T* g, float* out,
                        const WgradArgs& a, unsigned blocks,
                        cudaStream_t s) {
  constexpr size_t smem = gemm_smem_bytes<kTileCout>();
  auto kernel = wgrad_gemm_kernel<T, kTileCout, kVecX, kVecG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, s>>>(x, g, out, a);
  return cudaGetLastError();
}

template <typename T, int kTileCout>
cudaError_t launch_gemm(const T* x, const T* g, float* out,
                        const WgradArgs& a, unsigned blocks, bool vec_x,
                        bool vec_g, cudaStream_t s) {
  if (vec_x && vec_g)
    return launch_gemm<T, kTileCout, true, true>(x, g, out, a, blocks, s);
  if (vec_x)
    return launch_gemm<T, kTileCout, true, false>(x, g, out, a, blocks, s);
  if (vec_g)
    return launch_gemm<T, kTileCout, false, true>(x, g, out, a, blocks, s);
  return launch_gemm<T, kTileCout, false, false>(x, g, out, a, blocks, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int kTileCout>
cudaError_t resident_blocks(int* out) {
  constexpr size_t smem = gemm_smem_bytes<kTileCout>();
  auto kernel = wgrad_gemm_kernel<float, kTileCout, true, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kThreads,
                                                       smem);
}

template <int kTileCout>
cudaError_t launch_mma(const bf16* x, const bf16* g, float* out,
                       const WgradArgs& a, unsigned blocks, cudaStream_t s) {
  constexpr size_t smem = mma_smem_bytes<kTileCout>();
  auto kernel = wgrad_mma_kernel<kTileCout>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, s>>>(x, g, out, a);
  return cudaGetLastError();
}

template <int kTileCout>
cudaError_t mma_resident_blocks(int* out) {
  constexpr size_t smem = mma_smem_bytes<kTileCout>();
  auto kernel = wgrad_mma_kernel<kTileCout>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kThreads,
                                                       smem);
}

// The route of a layer (core/conv_plan.py, wgrad_route): depthwise where
// groups == Cin == Cout; on bf16 operands mma where Cin/g % 16 == 0 and
// Cout/g % 8 == 0; else gemm.
template <typename T>
int wgrad_route_of(int cin, int cout, int groups) {
  if (groups == cin && cin == cout) return kRouteDepthwise;
  if (sizeof(T) == 2 && (cin / groups) % kBf16MmaK == 0 &&
      (cout / groups) % kBf16MmaN == 0)
    return kRouteMma;
  return kRouteGemm;
}

// The launcher of both entries.  The GEMM loaders' vector instances need
// the channels of a group in whole vectors (4 f32 or 8 bf16: 16 bytes)
// and 16-byte aligned operands; route mma needs both always.
template <typename T>
int wgrad_entry(const T* x, const T* g, float* ws, float* dw, int n, int h,
                int wd, int cin, int cout, int kh, int kw, int stride,
                int pad_top, int pad_left, int groups, int h_out, int w_out,
                int tile_go, int route, int tile_cout, int blocks,
                void* stream) {
  if (n < 1 || kh < 1 || kw < 1 || stride < 1 || groups < 1 ||
      cin % groups != 0 || cout % groups != 0 || h_out < 1 || w_out < 1 ||
      tile_go < 1 ||
      pad_top < 0 || pad_left < 0)
    return (int)cudaErrorInvalidValue;
  if (route != wgrad_route_of<T>(cin, cout, groups))
    return (int)cudaErrorInvalidValue;
  if (route != kRouteDepthwise && tile_cout != 64 && tile_cout != 128)
    return (int)cudaErrorInvalidValue;
  if (route == kRouteMma && !(aligned16(x) && aligned16(g)))
    return (int)cudaErrorInvalidValue;
  WgradArgs a;
  a.n = n; a.h = h; a.w = wd; a.cin = cin; a.cout = cout; a.kh = kh;
  a.kw = kw;
  a.stride = stride; a.pad_top = pad_top; a.pad_left = pad_left;
  a.groups = groups; a.h_out = h_out; a.w_out = w_out; a.tile_go = tile_go;
  a.chunks = (n * h_out + tile_go - 1) / tile_go;
  a.cin_pg = cin / groups;
  a.cout_pg = cout / groups;
  a.rows = kh * kw * a.cin_pg;
  a.row_tiles = (a.rows + kTileRows - 1) / kTileRows;
  a.co_tiles = (a.cout_pg + tile_cout - 1) / tile_cout;
  if (a.chunks > 1 && ws == dw) return (int)cudaErrorInvalidValue;
  const long long tiles =
      route == kRouteDepthwise
          ? ((long long)kh * kw * cin + kThreads - 1) / kThreads
          : (long long)groups * a.row_tiles * a.co_tiles;
  if (tiles * a.chunks != (long long)blocks || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = a.chunks > 1 ? ws : dw;
  cudaError_t err;
  if (route == kRouteDepthwise) {
    wgrad_depthwise_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
        x, g, out, a);
    err = cudaGetLastError();
  } else if (route == kRouteMma) {
    if constexpr (std::is_same<T, bf16>::value)
      err = tile_cout == 64
                ? launch_mma<64>(x, g, out, a, (unsigned)blocks, s)
                : launch_mma<128>(x, g, out, a, (unsigned)blocks, s);
    else
      err = cudaErrorInvalidValue;   // not reached: f32 has no route mma
  } else {
    constexpr int kVec = 16 / (int)sizeof(T);    // elements a vector
    const bool vec_x = a.cin_pg % kVec == 0 && aligned16(x);
    const bool vec_g = a.cout_pg % kVec == 0 && aligned16(g) &&
                       aligned16(out);
    err = tile_cout == 64
              ? launch_gemm<T, 64>(x, g, out, a, (unsigned)blocks, vec_x,
                                   vec_g, s)
              : launch_gemm<T, 128>(x, g, out, a, (unsigned)blocks, vec_x,
                                    vec_g, s);
  }
  if (err != cudaSuccess || a.chunks == 1) return (int)err;
  const size_t elems = (size_t)a.rows * cout;
  const bool vec = elems % 4 == 0 && aligned16(ws) && aligned16(dw);
  const size_t threads = vec ? elems / 4 : elems;
  const size_t rblocks = (threads + kThreads - 1) / kThreads;
  if (vec)
    wgrad_reduce_kernel<true><<<(unsigned)rblocks, kThreads, 0, s>>>(
        ws, dw, elems, a.chunks);
  else
    wgrad_reduce_kernel<false><<<(unsigned)rblocks, kThreads, 0, s>>>(
        ws, dw, elems, a.chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes by repro_torch/kernels/build.py.  Each
// launches on `stream` without synchronising and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a geometry the kernel
// cannot take).  `ws` holds chunks * KH*KW*Cin/groups * Cout floats; with a
// single chunk it may be `dw` itself.  dw and ws are f32 in both entries;
// x and g are f32 (trim_conv2d_wgrad) or bf16 (trim_conv2d_wgrad_bf16).
// WeightGradPlan decides the route (`route`: WgradRoute), the tile's
// columns (`tile_cout`, 64 or 128) and so the partial launch's `blocks`;
// this launcher takes those decisions as given and only checks them: the
// route must be the layer's (wgrad_route_of; route mma also needs 16-byte
// aligned x and g), and `blocks` must equal the count from this file's
// tile rows and threads, so a plan that prices another launch than the one
// made fails here instead of running.
extern "C" {

int trim_conv2d_wgrad(const float* x, const float* g, float* ws, float* dw,
                      int n, int h, int wd, int cin, int cout, int kh,
                      int kw, int stride, int pad_top, int pad_left,
                      int groups, int h_out, int w_out, int tile_go,
                      int route, int tile_cout, int blocks, void* stream) {
  return wgrad_entry<float>(x, g, ws, dw, n, h, wd, cin, cout, kh, kw,
                            stride, pad_top, pad_left, groups, h_out, w_out,
                            tile_go, route, tile_cout, blocks, stream);
}

int trim_conv2d_wgrad_bf16(const void* x, const void* g, float* ws,
                           float* dw, int n, int h, int wd, int cin,
                           int cout, int kh, int kw, int stride,
                           int pad_top, int pad_left, int groups, int h_out,
                           int w_out, int tile_go, int route,
                           int tile_cout, int blocks, void* stream) {
  return wgrad_entry<bf16>(static_cast<const bf16*>(x),
                           static_cast<const bf16*>(g), ws, dw, n, h, wd,
                           cin, cout, kh, kw, stride, pad_top, pad_left,
                           groups, h_out, w_out, tile_go, route,
                           tile_cout, blocks, stream);
}

// Resident blocks an SM of the GEMM route's tile of `tile_cout` columns
// (16-byte loaders), as the card reports it, into `*out`:
// WeightGradPlan's time model assumes WGRAD_BLOCKS_PER_SM of them.  The
// bf16 gemm instances share the stages and __launch_bounds__(kThreads, 2).
int trim_conv2d_wgrad_resident_blocks(int tile_cout, int* out) {
  if (tile_cout == 64) return (int)resident_blocks<64>(out);
  if (tile_cout == 128) return (int)resident_blocks<128>(out);
  return (int)cudaErrorInvalidValue;
}

// The same for route mma's instances: WGRAD_MMA_BLOCKS_PER_SM.
int trim_conv2d_wgrad_mma_resident_blocks(int tile_cout, int* out) {
  if (tile_cout == 64) return (int)mma_resident_blocks<64>(out);
  if (tile_cout == 128) return (int)mma_resident_blocks<128>(out);
  return (int)cudaErrorInvalidValue;
}

const char* trim_conv2d_wgrad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
