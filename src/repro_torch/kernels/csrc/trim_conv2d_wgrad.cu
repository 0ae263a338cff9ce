// Weight gradient of the 3D-TrIM convolution for NVIDIA Hopper (sm_90a),
// f32, hand-written CUDA.
//
// Replaces the TPU Pallas kernel _weight_grad_kernel of
// src/repro/kernels/trim_conv2d.py (:429; pallas_call :529).
//
// Math.  dw[ki,kj,ci,g*Cpg+co] = sum_{n,oh,ow} xpad[n, oh*s+ki, ow*s+kj,
// g*Cin_pg+ci] * dz[n,oh,ow,g*Cpg+co].  Per group, dw is a (K*K*Cin_pg) x
// Cpg matrix whose rows are the flattened (ki, kj, ci) axis: the product
// of the im2col'd input (positions x rows) and the cotangent (positions x
// Cpg) over the positions, formed on the fly.  'same'/'valid' padding is
// virtual, as in the forward kernel: the loader writes zeros outside the
// image, so no padded copy of x exists.
//
// Geometry (core/conv_plan.py WeightGradPlan).  The TPU kernel sweeps
// (image, strip of cotangent rows) in sequence into one resident f32
// block.  Blocks here run in parallel and in no order, so the sweep is cut
// into chunks of tile_go consecutive rows of the flattened (n, oh) axis.
// A block owns (chunk, group, 64-row tile, 64-column tile).  It stages 32
// positions at a time of its input rows and cotangent columns in shared
// memory; each thread keeps a 4 x 4 tile of accumulators in registers and
// reads one float4 of each staged tile per position.
//
// Determinism without float atomics.  Entry 1 (wgrad_partial_kernel)
// writes one partial dw per chunk into a workspace: each element is ONE
// fmaf chain over the chunk's positions in ascending (n, oh, ow) order.
// Entry 2 (wgrad_reduce_kernel) sums the partials of each element in
// ascending chunk order, one fadd chain.  The result depends on the shape
// and the data only, so two launches on the same inputs are bitwise equal.
// With a single chunk, entry 1 writes dw itself and entry 2 is skipped.
//
// What bounds it on the H100.  At VGG-16 shapes the weight gradient does
// as many FLOPs as the forward conv on as many bytes, hundreds of FLOPs per
// byte, so the bound is operations: 67 TFLOP/s of non-tensor f32.  This
// first kernel issues two 16-byte shared-memory loads per sixteen FMAs and
// stages without overlap (two barriers per 32 positions); the workspace
// adds 8 bytes of traffic per dw element and chunk, which the plan keeps
// below the FLOPs by giving a chunk at least 256 positions (64 FLOPs per
// workspace byte).  Small Cin/g packs several taps into one row tile;
// a depthwise conv (9 rows and one column per group) keeps 1 of 256
// threads' accumulators busy.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;     // threads per block
constexpr int kTileRows = 64;     // rows of the flattened (ki, kj, ci) axis
constexpr int kTileCout = 64;     // output channels per block
constexpr int kPositions = 32;    // cotangent positions staged per step
constexpr int kLoadLanes = kThreads / kTileRows;  // positions loaded at once

static_assert(kTileRows == kTileCout, "one loader column serves both tiles");
static_assert(kTileRows == 4 * 16 && kThreads == 16 * 16,
              "a 16 x 16 thread grid of 4 x 4 accumulator tiles");

struct WgradArgs {
  int n, h, w, cin, cout, k, stride, pad_top, pad_left, groups;
  int h_out, w_out;
  int tile_go;     // cotangent rows per chunk
  int chunks;
  int rows;        // K * K * Cin/groups
  int row_tiles, co_tiles;
};

__global__ void __launch_bounds__(kThreads)
wgrad_partial_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     float* __restrict__ ws, const WgradArgs a) {
  __shared__ __align__(16) float xs[kPositions][kTileRows];
  __shared__ __align__(16) float gs[kPositions][kTileCout];
  const int cin_pg = a.cin / a.groups;
  const int cout_pg = a.cout / a.groups;

  int b = blockIdx.x;
  const int cot = b % a.co_tiles; b /= a.co_tiles;
  const int rt = b % a.row_tiles; b /= a.row_tiles;
  const int grp = b % a.groups;
  const int chunk = b / a.groups;

  const int tid = threadIdx.x;
  // Loader role: one column of both staged tiles, positions lp + 4i.
  const int lc = tid % kTileRows;
  const int lp = tid / kTileRows;
  const int r = rt * kTileRows + lc;
  const bool row_ok = r < a.rows;
  int ki = 0, kj = 0, ci = 0;
  if (row_ok) {
    const int tap = r / cin_pg;
    ci = r - tap * cin_pg;
    ki = tap / a.k;
    kj = tap - ki * a.k;
  }
  const int co = cot * kTileCout + lc;
  const bool co_ok = co < cout_pg;
  const float* xcol = x + grp * cin_pg + ci;
  const float* gcol = g + grp * cout_pg + co;

  const int total_rows = a.n * a.h_out;
  const int row0 = chunk * a.tile_go;
  const int row1 = min(total_rows, row0 + a.tile_go);
  const int npos = (row1 - row0) * a.w_out;

  // Compute role: rows 4*ty.., columns 4*tx.. of the block's tile.
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int p0 = 0; p0 < npos; p0 += kPositions) {
    const int np = min(kPositions, npos - p0);
#pragma unroll
    for (int i = 0; i < kPositions / kLoadLanes; ++i) {
      const int p = lp + i * kLoadLanes;
      float xv = 0.0f, gv = 0.0f;
      if (p < np) {
        const int q = p0 + p;
        const int orow = row0 + q / a.w_out;
        const int ow = q - (q / a.w_out) * a.w_out;
        const int img = orow / a.h_out;
        const int oh = orow - img * a.h_out;
        if (co_ok)
          gv = gcol[((size_t)orow * a.w_out + ow) * a.cout];
        if (row_ok) {
          const int ih = oh * a.stride + ki - a.pad_top;
          const int iw = ow * a.stride + kj - a.pad_left;
          if (ih >= 0 && ih < a.h && iw >= 0 && iw < a.w)
            xv = xcol[(((size_t)img * a.h + ih) * a.w + iw) * a.cin];
        }
      }
      xs[p][lc] = xv;
      gs[p][lc] = gv;
    }
    __syncthreads();
#pragma unroll 4
    for (int p = 0; p < np; ++p) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[p][4 * ty]);
      const float4 gv = *reinterpret_cast<const float4*>(&gs[p][4 * tx]);
      const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
      const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xr[i], gr[j], acc[i][j]);
    }
    __syncthreads();  // every read of the staged tiles is done
  }

  float* out = ws + (size_t)chunk * a.rows * a.cout + grp * cout_pg;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = rt * kTileRows + 4 * ty + i;
    if (row >= a.rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = cot * kTileCout + 4 * tx + j;
      if (c < cout_pg) out[(size_t)row * a.cout + c] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
wgrad_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                    size_t elems, int chunks) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= elems) return;
  float s = ws[e];
  for (int c = 1; c < chunks; ++c) s += ws[(size_t)c * elems + e];
  dw[e] = s;
}

}  // namespace

// C entry point, bound with ctypes by repro_torch/kernels/build.py.  It
// launches on `stream` without synchronising and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a geometry the kernel
// cannot take).  `ws` holds chunks * K*K*Cin/groups * Cout floats; with a
// single chunk it may be `dw` itself.
extern "C" {

int trim_conv2d_wgrad(const float* x, const float* g, float* ws, float* dw,
                      int n, int h, int wd, int cin, int cout, int k,
                      int stride, int pad_top, int pad_left, int groups,
                      int h_out, int w_out, int tile_go, void* stream) {
  if (n < 1 || k < 1 || stride < 1 || groups < 1 || cin % groups != 0 ||
      cout % groups != 0 || h_out < 1 || w_out < 1 || tile_go < 1 ||
      pad_top < 0 || pad_left < 0)
    return (int)cudaErrorInvalidValue;
  WgradArgs a;
  a.n = n; a.h = h; a.w = wd; a.cin = cin; a.cout = cout; a.k = k;
  a.stride = stride; a.pad_top = pad_top; a.pad_left = pad_left;
  a.groups = groups; a.h_out = h_out; a.w_out = w_out; a.tile_go = tile_go;
  a.chunks = (n * h_out + tile_go - 1) / tile_go;
  a.rows = k * k * (cin / groups);
  a.row_tiles = (a.rows + kTileRows - 1) / kTileRows;
  a.co_tiles = (cout / groups + kTileCout - 1) / kTileCout;
  if (a.chunks > 1 && ws == dw) return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)a.chunks * groups * a.row_tiles * a.co_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  wgrad_partial_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      x, g, a.chunks > 1 ? ws : dw, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.chunks == 1) return (int)err;
  const size_t elems = (size_t)a.rows * cout;
  const size_t rblocks = (elems + kThreads - 1) / kThreads;
  wgrad_reduce_kernel<<<(unsigned)rblocks, kThreads, 0, s>>>(ws, dw, elems,
                                                               a.chunks);
  return (int)cudaGetLastError();
}

const char* trim_conv2d_wgrad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
