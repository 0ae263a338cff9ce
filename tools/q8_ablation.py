#!/usr/bin/env python3
"""Where the int8 conv kernel's time goes, on a card without ``ncu``.

Run from the repository root on a host with one NVIDIA GPU:

    python3 tools/q8_ablation.py [--layers conv2,conv6,conv9] [--batch 8]

Three measurements, printed as a table and one JSON line:

1. Ablations.  Copies of ``csrc/trim_conv2d_q8.cu`` with one part removed
   (the MMAs, the weight copies, the k-steps, the epilogue's stores) are
   built with ``nvcc`` beside the real one (``build/q8_ablation/``) and
   each is timed (CUDA events, 20 launches) on the plan of each layer of
   full-width VGG-16.  The variants compute garbage; only their times
   mean anything.  Each substitution is asserted to match the source, so
   an edit of the kernel that moves one breaks this tool loudly.
2. A ``clock64()`` probe in thread 0 of the first block of the mma
   kernel: the median SM clocks of a weight stage spent in the
   ``cp.async`` wait, the barrier, the copies' issue and the k-steps.
3. ``mma.sync.m16n8k32`` s8 from registers alone (8 accumulators a warp,
   256 threads a block, one and two blocks an SM): the card's ceiling for
   the instruction the kernel issues.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "q8_ablation")

MMA = "              mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);"
WCOPY = "    for (int u = 0; u < n_blk / 32; ++u) {"
KLOOP = "      const int steps = min(kStageSteps, a.k_steps - st * kStageSteps);"
STORE = ("            *reinterpret_cast<float4*>(yp) =\n"
         "                *reinterpret_cast<const float4*>(sp);")
ABLATIONS = {
    "no_mma": (MMA, "              acc[i][j][0] += (int)(af[i][0] ^ "
                    "bf[j][0]);"),
    "no_weight_copy": (WCOPY, "    for (int u = 0; u < 0; ++u) {"),
    "no_k_steps": (KLOOP, "      const int steps = 0;"),
    "no_store": (STORE, "            if (a.activation == 99) *yp = sp[0];"),
}
REC = "      if (rec && pn < 4000) q8_probe[pn++] = clock64();\n"
PROBES = [  # (anchor, its replacement): four records a weight stage
    ("  const Tile tl = tile_of(a, x);\n",
     "  const Tile tl = tile_of(a, x);\n  const bool rec = threadIdx.x == 0 "
     "&& blockIdx.x == 0 && blockIdx.y == 0;\n  int pn = 1;\n"),
    ("      if (st == 0 && t > tl.t_first && drain)\n",
     REC + "      if (st == 0 && t > tl.t_first && drain)\n"),
    ("      __syncthreads();               // everyone's; stage gs-1 "
     "consumed\n",
     REC + "      __syncthreads();               // everyone's; stage gs-1 "
     "consumed\n" + REC),
    ("      cp_async_commit();\n\n      if (kIm2col && st == 0) {",
     "      cp_async_commit();\n" + REC + "\n      if (kIm2col && st == 0) {"),
]
IMMA_BENCH = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void imma_regs(int* out, int iters, uint32_t seed) {
  int acc[8][4] = {};
  const uint32_t a[4] = {seed, seed * 3u, seed * 5u, seed * 7u};
  const uint32_t b0 = seed ^ threadIdx.x, b1 = seed + threadIdx.x;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int n = 0; n < 8; ++n)
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+r"(acc[n][0]), "+r"(acc[n][1]), "+r"(acc[n][2]), "+r"(acc[n][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  int s = 0;
  for (int n = 0; n < 8; ++n) s += acc[n][0] + acc[n][1] + acc[n][2] + acc[n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int imma_bench(int blocks, int threads, int iters, float* ms) {
  int* out;
  cudaMalloc(&out, (size_t)blocks * threads * sizeof(int));
  imma_regs<<<blocks, threads>>>(out, 16, 1);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  imma_regs<<<blocks, threads>>>(out, iters, 1);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  cudaEventElapsedTime(ms, a, b);
  cudaFree(out);
  return (int)cudaGetLastError();
}
"""


def build_variants(src: str) -> dict:
    """Source text of each variant: the kernel, each ablation, the probe."""
    variants = {"kernel": src}
    for name, (old, new) in ABLATIONS.items():
        if src.count(old) != 1:
            raise SystemExit(f"q8_ablation: {name}: anchor not found once")
        variants[name] = src.replace(old, new)
    probe = src.replace("namespace {\n",
                        "__device__ long long q8_probe[4096];\n"
                        "namespace {\n", 1)
    for anchor, replacement in PROBES:
        if anchor not in probe:
            raise SystemExit(f"q8_ablation: probe anchor {anchor!r} missing")
        probe = probe.replace(anchor, replacement, 1)
    probe += ('\nextern "C" int q8_probe_read(long long* out) {\n'
              "  return (int)cudaMemcpyFromSymbol(out, q8_probe, "
              "sizeof(q8_probe));\n}\n")
    variants["probe"] = probe
    return variants


def compile_all(variants: dict) -> dict:
    """One nvcc a source, all started together; name -> library path."""
    from repro_torch.kernels.build import CSRC, NVCC_FLAGS, nvcc
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    sources = dict(variants, imma_bench=IMMA_BENCH)
    for name, text in sources.items():
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(OUT, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"q8_ablation: nvcc failed for {name}:\n{log}")
        libs[name] = lib
    return libs


def bind(path: str) -> ctypes.CDLL:
    from repro_torch.kernels.build import SOURCES
    lib = ctypes.CDLL(path)
    for fn, argtypes in SOURCES["trim_conv2d_q8"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", default="conv1,conv2,conv4,conv6,conv9,"
                                        "conv11")
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("q8_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.conv_plan import Q8_ROUTES, ConvPlan
    from repro_torch.core.model import vgg16_layers
    from repro_torch.kernels import trim_conv2d as tc
    from repro_torch.kernels.build import CSRC

    src = (CSRC / "trim_conv2d_q8.cu").read_text()
    libs = compile_all(build_variants(src))
    kernels = {n: bind(p) for n, p in libs.items() if n != "imma_bench"}
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    result = {"card": card, "batch": args.batch, "layers": {}}
    wanted = args.layers.split(",")
    for layer in vgg16_layers():
        if layer.name not in wanted:
            continue
        xs = (args.batch, layer.ifmap, layer.ifmap, layer.in_channels)
        ws = (3, 3, layer.in_channels, layer.out_channels)
        p = ConvPlan.build(xs, ws, pad=1, dtype_bytes=1)
        x = torch.randint(-128, 128, xs, generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-127, 128, ws, generator=gen, device="cuda",
                          dtype=torch.int8)
        wp = tc.pack_q8_weights(w)
        bq = torch.zeros((ws[3],), device="cuda", dtype=torch.int32)
        sc = torch.ones((ws[3],), device="cuda")
        y = torch.empty(p.out_shape, device="cuda")
        call = (x.data_ptr(), wp.data_ptr(), bq.data_ptr(), sc.data_ptr(),
                y.data_ptr(), p.n, p.h, p.w, p.cin, p.cout, p.kh, p.stride,
                p.pads[0][0], p.pads[1][0], p.groups, p.h_out, p.w_out,
                p.th_out, p.tile_w, p.tile_cout, p.strips_per_segment,
                p.ring_rows, p.cin_stride, 0, 1, Q8_ROUTES.index(p.route),
                p.warps_n, p.warps_k, p.m_frags, stream)
        row = {"tile": f"{p.th_out}x{p.tile_w}x{p.tile_cout}",
               "warps": f"{p.warps_m}x{p.warps_n}x{p.warps_k}/{p.m_frags}",
               "blocks": p.blocks, "k_steps": p.k_steps}
        for name, lib in kernels.items():
            for _ in range(3):
                if lib.trim_conv2d_q8_carry(*call) != 0:
                    raise SystemExit(f"q8_ablation: {name} launch failed")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                lib.trim_conv2d_q8_carry(*call)
            end.record()
            torch.cuda.synchronize()
            row[name] = start.elapsed_time(end) / 20
        buf = (ctypes.c_longlong * 4096)()
        if kernels["probe"].q8_probe_read(buf) != 0:
            raise SystemExit("q8_ablation: probe read failed")
        # per stage: top, after the wait, after the barrier, after the issue
        v = [buf[i] for i in range(1, 1 + 4 * p.weight_stages)]
        stages = [v[i:i + 4] for i in range(0, len(v) - 4, 4)]
        for key, i in (("wait", 0), ("barrier", 1), ("issue", 2)):
            row[f"clk_{key}"] = statistics.median(
                s[i + 1] - s[i] for s in stages) if stages else 0
        row["clk_k_steps"] = statistics.median(
            v[i + 4] - v[i + 3] for i in range(0, len(v) - 4, 4)) \
            if stages else 0
        result["layers"][layer.name] = row
        print(f"{layer.name:7s} {row['tile']:>9s} {row['warps']:>8s} "
              + " ".join(f"{n} {row[n]:.4f}" for n in kernels if n != "probe")
              + f" | stage clocks: wait {row['clk_wait']}, barrier "
              f"{row['clk_barrier']}, issue {row['clk_issue']}, k-steps "
              f"{row['clk_k_steps']}", flush=True)
        del x, w, wp, y
    bench = ctypes.CDLL(libs["imma_bench"])
    bench.imma_bench.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    result["imma_tops"] = {}
    for bps in (1, 2):
        ms = ctypes.c_float(0)
        iters = 4096
        if bench.imma_bench(132 * bps, 256, iters, ctypes.byref(ms)) != 0:
            raise SystemExit("q8_ablation: IMMA benchmark failed")
        ops = 2 * 16 * 8 * 32 * 8 * iters * 8 * 132 * bps
        result["imma_tops"][f"{bps}_blocks_an_sm"] = ops / ms.value / 1e9
    print(f"mma.sync s8 from registers: {result['imma_tops']} TOPS")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
