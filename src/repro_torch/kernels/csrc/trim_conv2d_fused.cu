// Fused residency group for NVIDIA Hopper (sm_90a), f32, hand-written CUDA.
//
// Replaces the TPU Pallas kernel _fused_kernel of
// src/repro/kernels/trim_conv2d_fused.py (:102, with _stage_conv :67 and
// _stage_pool :87): a chain conv -> [max-pool] -> conv ... runs in one launch
// and every interior activation stays on chip.  The geometry comes from
// repro_torch/core/fuse_plan.py (FusedGroup); the wrapper is
// repro_torch/kernels/trim_conv2d_fused.py.
//
// Geometry.  One block owns (image, strip, band): a tile of strip_rows x
// band_cols pooled outputs of the LAST stage.  Each stage's ranges are affine
// in (strip, band) (FusedStage): stage i reads an in_rows x in_cols x cin
// tile of its input and produces a pool_rows x pool_cols x cout tile of its
// pooled output, which is stage i+1's input tile.  The TPU strip spans the
// full width in 16 MiB of VMEM; a block here has 227 KB, so tiles are cut in
// both directions and a stage's halo rows AND columns are computed by every
// tile that needs them.
//   * Stage 0 loads its input window into shared memory; 'same' padding is
//     virtual, as in trim_conv2d.cu (zeros outside the image).
//   * Each stage computes all its C_out, C_out tile by C_out tile, in passes
//     of as many pooled positions as the threads' registers hold.  A thread
//     holds per_thread pooled positions x pool_window^2 conv outputs, so the
//     max-pool runs in registers after the epilogue and no pre-pool buffer
//     exists.
//   * An interior stage writes its pooled outputs into the other of two
//     ping-pong buffers (stage i's input lives in buffer i % 2) and zeroes
//     every row and column outside the stage's valid pooled extent: those
//     zeros are exactly the next conv's 'same' padding, and valid outputs
//     never read anything else (the JAX kernel's argument, on both axes).
//   * The last stage writes its valid pooled outputs to device memory.
//   * Weights stream through shared memory in chunks of 32 input channels of
//     one tap, as in the per-layer kernel; each pass streams them once.
//
// Order.  Every conv output element is ONE fmaf chain in (ki, kj, ci) order
// from 0.0f, then + bias, then activate() of epilogue.cuh -- the same
// arithmetic as trim_conv2d.cu.  Max-pooling picks one of its inputs
// exactly.  So a fused group is bitwise equal to the per-layer carry chain
// (conv kernel, then a separate max-pool), and a served row to forward_one.
//
// What bounds it on the H100.  At VGG-16's early layers the group does
// hundreds of FLOPs per byte it must move, so the bound is operations:
// 67 TFLOP/s of non-tensor f32.  Fusing cuts the bytes the per-layer chain
// moves (the interior ofmap and the pool's read and write never reach
// device memory) at the cost of the recomputed halo (1.01-1.14x FLOPs on the
// VGG-16 groups the plan picks).  The inner loop is the per-layer kernel's
// (one shared-memory load of x per 2-4 FMAs, one block of 256 threads per SM
// at 160-175 KB of shared memory), so it runs at that kernel's few TFLOP/s;
// clusters with distributed shared memory, wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <stddef.h>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;          // threads per block
constexpr int kMaxStages = 8;          // stages of one launch
constexpr int kMaxSlots = 9;           // conv outputs per thread per pass
constexpr int kMaxCout = 4;            // output channels per thread
constexpr int kWeightChunk = 32;       // input channels per staged chunk
constexpr int kMaxSmemBytes = 232448;  // H100: 227 KB opt-in per block
constexpr int kHeader = 10;            // ints before the per-stage fields
constexpr int kStageFields = 23;       // ints per stage (see make_args)

struct StageArgs {
  const float* w;  // (K, K, cin, cout)
  const float* b;  // (cout,) or nullptr
  int cin, cout, k, stride, ps, pw, h_pool, w_pool;
  int in_rows, in_cols, pool_rows, pool_cols;
  int in_row_start, in_row_step, in_col_start, in_col_step;
  int pool_row_start, pool_row_step, pool_col_start, pool_col_step;
  int tile_cout, threads_cout, per_thread;
};

struct FusedArgs {
  int n, h, w, cin, depth, n_strips, n_bands;
  int buf0, buf1, wchunk;  // floats: ping-pong buffers, weight chunk width
  int activation;          // activate()'s code (epilogue.cuh)
  StageArgs st[kMaxStages];
};

__global__ void __launch_bounds__(kThreads)
trim_conv2d_fused_kernel(const float* __restrict__ x, float* __restrict__ y,
                         const FusedArgs a) {
  extern __shared__ float smem[];
  float* const buf0 = smem;
  float* const buf1 = smem + a.buf0;
  float* const ws = smem + a.buf0 + a.buf1;  // [kWeightChunk][tile_cout]

  int bid = blockIdx.x;
  const int band = bid % a.n_bands; bid /= a.n_bands;
  const int strip = bid % a.n_strips;
  const int img = bid / a.n_strips;
  const int tid = threadIdx.x;

  {  // stage 0's input window, zeros outside the image
    const StageArgs& s0 = a.st[0];
    const int r0 = s0.in_row_start + strip * s0.in_row_step;
    const int c0 = s0.in_col_start + band * s0.in_col_step;
    const float* xin = x + (size_t)img * a.h * a.w * a.cin;
    const int row_len = s0.in_cols * a.cin;
    const int total = s0.in_rows * row_len;
    for (int idx = tid; idx < total; idx += kThreads) {
      const int r = idx / row_len;
      const int rem = idx - r * row_len;
      const int c = rem / a.cin;
      const int ci = rem - c * a.cin;
      const int ih = r0 + r, iw = c0 + c;
      float v = 0.0f;
      if (ih >= 0 && ih < a.h && iw >= 0 && iw < a.w)
        v = xin[((size_t)ih * a.w + iw) * a.cin + ci];
      buf0[idx] = v;
    }
  }

  for (int i = 0; i < a.depth; ++i) {
    const StageArgs& st = a.st[i];
    const float* in = (i & 1) ? buf1 : buf0;
    float* out = (i & 1) ? buf0 : buf1;
    const bool last = i == a.depth - 1;
    const int cin = st.cin, cout = st.cout, k = st.k, s = st.stride;
    const int ps = st.ps, pw = st.pw, pw2 = st.pw * st.pw;
    const int tc = st.threads_cout;
    const int tx = tid % tc, ty = tid / tc;
    const int pthreads = kThreads / tc;
    const int cpt = st.tile_cout / tc;
    const int per_pass = pthreads * st.per_thread;
    const int positions = st.pool_rows * st.pool_cols;
    const int co_tiles = (cout + st.tile_cout - 1) / st.tile_cout;
    const int gr0 = st.pool_row_start + strip * st.pool_row_step;
    const int gc0 = st.pool_col_start + band * st.pool_col_step;

    for (int cot = 0; cot < co_tiles; ++cot) {
      for (int p0 = 0; p0 < positions; p0 += per_pass) {
        // pooled positions p0 + ty + j * pthreads, j < held, each taking
        // pw2 consecutive slots (its pool window, row-major)
        const int left = positions - p0 - ty;
        const int held = (ty < pthreads && left > 0)
                             ? min(st.per_thread, (left + pthreads - 1) / pthreads)
                             : 0;
        const int slots = held * pw2;

        float acc[kMaxSlots][kMaxCout];
#pragma unroll
        for (int m = 0; m < kMaxSlots; ++m)
#pragma unroll
          for (int j = 0; j < kMaxCout; ++j) acc[m][j] = 0.0f;

        for (int ki = 0; ki < k; ++ki) {
          for (int kj = 0; kj < k; ++kj) {
            int off[kMaxSlots];
#pragma unroll
            for (int m = 0; m < kMaxSlots; ++m) {
              int o = 0;  // idle slots read a valid address, never stored
              if (m < slots) {
                const int j = m / pw2, wm = m - j * pw2;
                const int wi = wm / pw, wj = wm - wi * pw;
                const int p = p0 + ty + j * pthreads;
                const int pr = p / st.pool_cols, pc = p - pr * st.pool_cols;
                const int r = (pr * ps + wi) * s + ki;
                const int c = (pc * ps + wj) * s + kj;
                o = (r * st.in_cols + c) * cin;
              }
              off[m] = o;
            }
            const float* wtap = st.w + (size_t)(ki * k + kj) * cin * cout;
            for (int ci0 = 0; ci0 < cin; ci0 += kWeightChunk) {
              const int nc = min(kWeightChunk, cin - ci0);
              __syncthreads();  // previous chunk consumed; buffers written
              for (int idx = tid; idx < nc * st.tile_cout; idx += kThreads) {
                const int cc = idx / st.tile_cout, co = idx - cc * st.tile_cout;
                const int cg = cot * st.tile_cout + co;
                ws[idx] = cg < cout ? wtap[(size_t)(ci0 + cc) * cout + cg] : 0.0f;
              }
              __syncthreads();
              if (slots > 0) {
                for (int cc = 0; cc < nc; ++cc) {
                  float wv[kMaxCout];
#pragma unroll
                  for (int j = 0; j < kMaxCout; ++j)
                    wv[j] = j < cpt ? ws[cc * st.tile_cout + tx + j * tc] : 0.0f;
#pragma unroll
                  for (int m = 0; m < kMaxSlots; ++m) {
                    if (m < slots) {
                      const float xv = in[off[m] + ci0 + cc];
#pragma unroll
                      for (int j = 0; j < kMaxCout; ++j)
                        if (j < cpt) acc[m][j] = fmaf(xv, wv[j], acc[m][j]);
                    }
                  }
                }
              }
            }
          }
        }

        // epilogue: + bias, activation, max over the pool window, mask
        float mx[kMaxCout];
#pragma unroll
        for (int m = 0; m < kMaxSlots; ++m) {
          if (m >= slots) continue;
          const int j = m / pw2, wm = m - j * pw2;
#pragma unroll
          for (int jj = 0; jj < kMaxCout; ++jj) {
            const int co = cot * st.tile_cout + tx + jj * tc;
            if (jj >= cpt || co >= cout) continue;
            float v = acc[m][jj];
            if (st.b != nullptr) v = v + st.b[co];
            v = activate(v, a.activation);
            mx[jj] = wm == 0 ? v : fmaxf(mx[jj], v);
          }
          if (wm != pw2 - 1) continue;
          const int p = p0 + ty + j * pthreads;
          const int pr = p / st.pool_cols, pc = p - pr * st.pool_cols;
          const int gr = gr0 + pr, gc = gc0 + pc;
          const bool valid = gr >= 0 && gr < st.h_pool && gc >= 0 && gc < st.w_pool;
#pragma unroll
          for (int jj = 0; jj < kMaxCout; ++jj) {
            const int co = cot * st.tile_cout + tx + jj * tc;
            if (jj >= cpt || co >= cout) continue;
            if (!last)
              out[(pr * st.pool_cols + pc) * cout + co] = valid ? mx[jj] : 0.0f;
            else if (valid)
              y[(((size_t)img * st.h_pool + gr) * st.w_pool + gc) * cout + co] =
                  mx[jj];
          }
        }
      }
    }
    __syncthreads();  // this stage's output complete, its input fully read
  }
}

// Unpack the host geometry (layout in trim_conv2d_fused below); returns
// false for one the kernel cannot take.
bool make_args(const void* const* wb, const int* g, int activation,
               FusedArgs* a) {
  a->n = g[0]; a->h = g[1]; a->w = g[2]; a->cin = g[3]; a->depth = g[4];
  a->n_strips = g[5]; a->n_bands = g[6]; a->buf0 = g[7]; a->buf1 = g[8];
  a->wchunk = g[9]; a->activation = activation;
  if (a->depth < 1 || a->depth > kMaxStages || a->n < 1 || a->n_strips < 1 ||
      a->n_bands < 1 || a->buf0 < 0 || a->buf1 < 0 || a->wchunk < 1)
    return false;
  for (int i = 0; i < a->depth; ++i) {
    const int* f = g + kHeader + i * kStageFields;
    StageArgs& st = a->st[i];
    st.w = static_cast<const float*>(wb[2 * i]);
    st.b = static_cast<const float*>(wb[2 * i + 1]);
    st.cin = f[0]; st.cout = f[1]; st.k = f[2]; st.stride = f[3];
    st.ps = f[4]; st.pw = f[5]; st.h_pool = f[6]; st.w_pool = f[7];
    st.in_rows = f[8]; st.in_cols = f[9];
    st.pool_rows = f[10]; st.pool_cols = f[11];
    st.in_row_start = f[12]; st.in_row_step = f[13];
    st.in_col_start = f[14]; st.in_col_step = f[15];
    st.pool_row_start = f[16]; st.pool_row_step = f[17];
    st.pool_col_start = f[18]; st.pool_col_step = f[19];
    st.tile_cout = f[20]; st.threads_cout = f[21]; st.per_thread = f[22];
    const int need_rows = ((st.pool_rows - 1) * st.ps + st.pw - 1) * st.stride + st.k;
    const int need_cols = ((st.pool_cols - 1) * st.ps + st.pw - 1) * st.stride + st.k;
    const long long tile = (long long)st.in_rows * st.in_cols * st.cin;
    if (st.w == nullptr || st.cin < 1 || st.cout < 1 || st.k < 1 ||
        st.stride < 1 || st.ps < 1 || st.pw < 1 || st.pool_rows < 1 ||
        st.pool_cols < 1 || st.threads_cout < 1 || st.threads_cout > 32 ||
        st.tile_cout % st.threads_cout != 0 ||
        st.tile_cout / st.threads_cout > kMaxCout ||
        st.tile_cout > a->wchunk || st.per_thread < 1 ||
        st.per_thread * st.pw * st.pw > kMaxSlots ||
        need_rows > st.in_rows || need_cols > st.in_cols ||
        tile > (i % 2 ? a->buf1 : a->buf0))
      return false;
    if (i == 0 ? st.cin != a->cin
               : (st.cin != a->st[i - 1].cout ||
                  st.in_rows != a->st[i - 1].pool_rows ||
                  st.in_cols != a->st[i - 1].pool_cols))
      return false;
  }
  return true;
}

}  // namespace

// C entry points, bound with ctypes by repro_torch/kernels/build.py.
extern "C" {

// x: (n, h, w, cin) stage-0 input; y: (n, h_pool, w_pool, cout) of the last
// stage.  wb: host array of 2 * depth device pointers (w0, b0, w1, b1, ...;
// a bias may be null).  geom: host ints, kHeader of them (n, h, w, cin,
// depth, n_strips, n_bands, buf0, buf1, wchunk), then kStageFields per stage
// in StageArgs' order from cin to per_thread.  Launches on `stream` without
// synchronising; returns cudaGetLastError(), or cudaErrorInvalidValue for a
// geometry the kernel cannot take.
int trim_conv2d_fused(const float* x, float* y, const void* const* wb,
                      const int* geom, int activation, void* stream) {
  FusedArgs a;
  if (!make_args(wb, geom, activation, &a)) return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)a.buf0 + a.buf1 + (size_t)kWeightChunk * a.wchunk) * sizeof(float);
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      trim_conv2d_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)a.n * a.n_strips * a.n_bands;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  trim_conv2d_fused_kernel<<<(unsigned)blocks, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(x, y, a);
  return (int)cudaGetLastError();
}

const char* trim_conv2d_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
