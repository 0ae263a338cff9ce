// 3D-TrIM convolution for NVIDIA Hopper (sm_90a), f32, hand-written CUDA.
//
// Replaces the TPU Pallas kernels of src/repro/kernels/trim_conv2d.py:
//   trim_conv2d_carry -> _carry_kernel (:127), with _tap_matmuls (:82) and
//                        _epilogue_store (:105), dataflow="carry"
//   trim_conv2d_halo  -> _halo_kernel (:162), dataflow="halo"
// Both entries instantiate one templated kernel: the two dataflows differ
// only in how the K-s boundary rows of a strip reach shared memory.
//
// Math.  y[n,oh,ow,g*Cpg+co] = act(bias + sum_{ki,kj,ci} xpad[n, oh*s+ki,
// ow*s+kj, g*Cin_pg+ci] * w[ki,kj,ci,g*Cpg+co]).  Every output element is ONE
// fp32 fmaf chain taken in a fixed order (ki, then kj, then ci ascending),
// then + bias, then the activation.  The order depends on nothing but the
// element, so carry and halo are bitwise equal, and a row's result does not
// depend on the batch it was served in.
//
// Geometry.  A block owns (image n, group g, C_out tile, column band of TW
// output columns).  Its input window is WR = TH + (K-s) padded rows x
// WC = (TW-1)*s + K columns x all Cin/g channels, kept in shared memory as a
// ring of WR row slots (slot = padded row mod WR), so strip t+1 reuses the
// K-s rows strip t already holds without moving them.  'same'/'valid'
// padding is virtual: the loader writes zeros outside the image, and the
// ragged bottom/right edges are masked at the store.
//   carry: one block walks all strips of its band top to bottom (the loop
//          replaces the TPU's sequential grid axis) and loads only the TH
//          fresh rows of each strip: the shadow registers.
//   halo:  one block per strip (blockIdx.y); it loads all WR rows, i.e.
//          re-reads its K-s predecessor rows from device memory.  Blocks are
//          independent and run in any order.
// Weights stream through shared memory in chunks of 32 input channels of one
// tap; each thread keeps up to 8 positions x 4 output channels of fp32
// accumulators in registers.
//
// What bounds it on the H100.  At VGG-16 shapes the conv does hundreds of
// FLOPs per byte it must move (input, weights, output), so the bound is
// operations: 67 TFLOP/s of non-tensor f32 (f32 without TF32 has no tensor
// cores).  This first kernel reaches a few TFLOP/s (PERF.md): with 8
// positions x 2 channels a thread, its inner loop issues ten shared-memory
// loads per sixteen FMAs, and carry runs only
// N * groups * C_out tiles * bands blocks (8 at 14x14x512, N=1) for 132 SMs
// because a block serialises its strips; at Cin >= 256 the window takes
// most of an SM's shared memory.  The design keeps what the TPU kernel kept
// out of device memory (each input row is read once per band by carry, the
// weights of a tap stream once per strip) and leaves speed to later work;
// halo trades the K-s re-read rows for one block per strip.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;        // threads per block
constexpr int kMaxPositions = 8;     // output positions per thread
constexpr int kMaxCout = 4;          // output channels per thread
constexpr int kWeightChunk = 32;     // input channels per staged weight chunk
constexpr int kMaxSmemBytes = 232448;  // H100: 227 KB opt-in per block

struct ConvArgs {
  int n, h, w, cin, cout, k, stride, pad_top, pad_left, groups;
  int h_out, w_out;
  int tile_h_out;    // output rows per strip
  int tile_w;        // output columns per band
  int tile_cout;     // output channels per block
  int threads_cout;  // threads along C_out (tile_cout = threads_cout * cpt)
  int n_strips, n_bands, co_tiles;
  int activation;    // 0 none, 1 relu, 2 gelu (tanh form), 3 silu
};

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return v < 0.0f ? 0.0f : v;
  if (act == 2) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  if (act == 3) return v / (1.0f + expf(-v));
  return v;
}

inline size_t smem_bytes(const ConvArgs& a) {
  const int cin_pg = a.cin / a.groups;
  const int carry = a.k > a.stride ? a.k - a.stride : 0;
  const size_t rows = (size_t)a.tile_h_out * a.stride + carry;
  const size_t cols = (size_t)(a.tile_w - 1) * a.stride + a.k;
  return (rows * cols * cin_pg + (size_t)kWeightChunk * a.tile_cout) *
         sizeof(float);
}

template <bool kCarry>
__global__ void __launch_bounds__(kThreads)
trim_conv2d_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                   const float* __restrict__ bias, float* __restrict__ y,
                   const ConvArgs a) {
  extern __shared__ float smem[];
  const int cin_pg = a.cin / a.groups;
  const int cout_pg = a.cout / a.groups;
  const int s = a.stride, k = a.k;
  const int th = a.tile_h_out * s;           // fresh input rows per strip
  const int kc = k > s ? k - s : 0;          // rows carried to the next strip
  const int wr = th + kc;                    // ring slots
  const int wc = (a.tile_w - 1) * s + k;     // window columns
  const int row_len = wc * cin_pg;           // floats per ring slot
  float* xs = smem;                          // [wr][wc][cin_pg]
  float* ws = smem + wr * row_len;           // [kWeightChunk][tile_cout]

  int b = blockIdx.x;
  const int band = b % a.n_bands; b /= a.n_bands;
  const int cot = b % a.co_tiles; b /= a.co_tiles;
  const int grp = b % a.groups;
  const int img = b / a.groups;

  const int tid = threadIdx.x;
  const int tx = tid % a.threads_cout;
  const int ty = tid / a.threads_cout;
  const int pthreads = kThreads / a.threads_cout;
  const bool computes = ty < pthreads;
  const int positions = a.tile_h_out * a.tile_w;
  const int mp = (positions + pthreads - 1) / pthreads;
  const int cpt = a.tile_cout / a.threads_cout;
  const int col0 = band * a.tile_w * s - a.pad_left;
  const float* xin = x + (size_t)img * a.h * a.w * a.cin + grp * cin_pg;
  const int co_base = grp * cout_pg + cot * a.tile_cout;

  // Padded rows [r0, r0 + rows) of this band into their ring slots.
  auto load_rows = [&](int r0, int rows) {
    const int total = rows * row_len;
    for (int idx = tid; idx < total; idx += kThreads) {
      const int r = idx / row_len;
      const int rem = idx - r * row_len;
      const int c = rem / cin_pg;
      const int ci = rem - c * cin_pg;
      const int ih = r0 + r - a.pad_top;
      const int iw = col0 + c;
      float v = 0.0f;
      if (ih >= 0 && ih < a.h && iw >= 0 && iw < a.w)
        v = xin[((size_t)ih * a.w + iw) * a.cin + ci];
      xs[((r0 + r) % wr) * row_len + rem] = v;
    }
  };

  // Taps + epilogue of strip t; the window is already in the ring.
  auto run_strip = [&](int t) {
    float acc[kMaxPositions][kMaxCout];
#pragma unroll
    for (int m = 0; m < kMaxPositions; ++m)
#pragma unroll
      for (int j = 0; j < kMaxCout; ++j) acc[m][j] = 0.0f;

    for (int ki = 0; ki < k; ++ki) {
      for (int kj = 0; kj < k; ++kj) {
        int off[kMaxPositions];
#pragma unroll
        for (int m = 0; m < kMaxPositions; ++m) {
          const int p = ty + m * pthreads;
          int o = 0;  // idle slots read a valid address and are never stored
          if (p < positions) {
            const int i = p / a.tile_w, c = p - i * a.tile_w;
            const int slot = (t * th + i * s + ki) % wr;
            o = (slot * wc + c * s + kj) * cin_pg;
          }
          off[m] = o;
        }
        const float* wtap = wt + (size_t)(ki * k + kj) * cin_pg * a.cout;
        for (int ci0 = 0; ci0 < cin_pg; ci0 += kWeightChunk) {
          const int nc = min(kWeightChunk, cin_pg - ci0);
          __syncthreads();  // previous chunk fully consumed; ring loads done
          for (int idx = tid; idx < nc * a.tile_cout; idx += kThreads) {
            const int cc = idx / a.tile_cout, co = idx - cc * a.tile_cout;
            ws[idx] = cot * a.tile_cout + co < cout_pg
                          ? wtap[(size_t)(ci0 + cc) * a.cout + co_base + co]
                          : 0.0f;
          }
          __syncthreads();
          if (computes) {
            for (int cc = 0; cc < nc; ++cc) {
              float wv[kMaxCout];
#pragma unroll
              for (int j = 0; j < kMaxCout; ++j)
                wv[j] = j < cpt ? ws[cc * a.tile_cout + tx + j * a.threads_cout]
                                : 0.0f;
#pragma unroll
              for (int m = 0; m < kMaxPositions; ++m) {
                if (m < mp) {
                  const float xv = xs[off[m] + ci0 + cc];
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

    if (!computes) return;
#pragma unroll
    for (int m = 0; m < kMaxPositions; ++m) {
      const int p = ty + m * pthreads;
      if (m >= mp || p >= positions) continue;
      const int i = p / a.tile_w, c = p - i * a.tile_w;
      const int oh = t * a.tile_h_out + i, ow = band * a.tile_w + c;
      if (oh >= a.h_out || ow >= a.w_out) continue;
      float* yrow = y + (((size_t)img * a.h_out + oh) * a.w_out + ow) * a.cout;
#pragma unroll
      for (int j = 0; j < kMaxCout; ++j) {
        const int co = tx + j * a.threads_cout;
        if (j >= cpt || cot * a.tile_cout + co >= cout_pg) continue;
        float v = acc[m][j];
        if (bias != nullptr) v = v + bias[co_base + co];
        yrow[co_base + co] = activate(v, a.activation);
      }
    }
  };

  if (kCarry) {
    for (int t = 0; t < a.n_strips; ++t) {
      __syncthreads();  // every read of the slots refilled below is done
      if (t == 0)
        load_rows(0, wr);
      else
        load_rows(t * th + kc, th);  // only the fresh rows; K-s carried
      run_strip(t);
    }
  } else {
    const int t = blockIdx.y;
    load_rows(t * th, wr);  // the strip plus its K-s predecessor rows
    run_strip(t);
  }
}

template <bool kCarry>
int launch(const float* x, const float* w, const float* bias, float* y,
           const ConvArgs& a, void* stream) {
  const int positions = a.tile_h_out * a.tile_w;
  if (a.threads_cout < 1 || a.threads_cout > 32 || a.tile_cout < 1 ||
      a.tile_cout % a.threads_cout != 0 ||
      a.tile_cout / a.threads_cout > kMaxCout ||
      positions > (kThreads / a.threads_cout) * kMaxPositions ||
      a.k < 1 || a.stride < 1 || a.groups < 1 || a.cin % a.groups != 0 ||
      a.cout % a.groups != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a);
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      trim_conv2d_kernel<kCarry>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.n * a.groups * a.co_tiles * a.n_bands,
                  kCarry ? 1 : a.n_strips);
  trim_conv2d_kernel<kCarry><<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, y, a);
  return (int)cudaGetLastError();
}

ConvArgs make_args(int n, int h, int w, int cin, int cout, int k, int stride,
                   int pad_top, int pad_left, int groups, int h_out, int w_out,
                   int tile_h_out, int tile_w, int tile_cout, int threads_cout,
                   int activation) {
  ConvArgs a;
  a.n = n; a.h = h; a.w = w; a.cin = cin; a.cout = cout; a.k = k;
  a.stride = stride; a.pad_top = pad_top; a.pad_left = pad_left;
  a.groups = groups; a.h_out = h_out; a.w_out = w_out;
  a.tile_h_out = tile_h_out; a.tile_w = tile_w; a.tile_cout = tile_cout;
  a.threads_cout = threads_cout;
  a.n_strips = (h_out + tile_h_out - 1) / tile_h_out;
  a.n_bands = (w_out + tile_w - 1) / tile_w;
  const int cout_pg = groups > 0 ? cout / groups : 0;
  a.co_tiles = tile_cout > 0 ? (cout_pg + tile_cout - 1) / tile_cout : 0;
  a.activation = activation;
  return a;
}

}  // namespace

// C entry points, bound with ctypes by repro_torch/kernels/build.py.  Each
// launches on `stream` without synchronising and returns cudaGetLastError()
// (or cudaErrorInvalidValue for a geometry the kernel cannot take).
extern "C" {

#define TRIM_CONV2D_ARGS                                                      \
  const float *x, const float *w, const float *bias, float *y, int n, int h,  \
      int wd, int cin, int cout, int k, int stride, int pad_top, int pad_left, \
      int groups, int h_out, int w_out, int tile_h_out, int tile_w,           \
      int tile_cout, int threads_cout, int activation, void *stream
#define TRIM_CONV2D_MAKE_ARGS                                                 \
  make_args(n, h, wd, cin, cout, k, stride, pad_top, pad_left, groups, h_out, \
            w_out, tile_h_out, tile_w, tile_cout, threads_cout, activation)

int trim_conv2d_carry(TRIM_CONV2D_ARGS) {
  return launch<true>(x, w, bias, y, TRIM_CONV2D_MAKE_ARGS, stream);
}

int trim_conv2d_halo(TRIM_CONV2D_ARGS) {
  return launch<false>(x, w, bias, y, TRIM_CONV2D_MAKE_ARGS, stream);
}

const char* trim_conv2d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
