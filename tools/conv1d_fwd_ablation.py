#!/usr/bin/env python3
"""What the conv1d forward kernel's schedule costs, on a card without
``ncu``: copies of ``csrc/trim_conv1d.cu`` with one thing changed, each
timed over a range of run lengths.

Run from the repository root on a host with one NVIDIA GPU:

    python3 tools/conv1d_fwd_ablation.py [--variants base,ahead8]
                                         [--tile-ls 256,128,64,32,16]

Each variant is built with ``nvcc`` beside the real kernel
(``build/conv1d_fwd_ablation/``) and bound with ctypes through the same C
entry points; each is launched on the plan's geometry at every run
length of ``--tile-ls`` (``Conv1dPlan.build(tile_l=...)``) at the forward
rows (a), (b) and the dx rows (c), (d) of ``tools/conv1d_wgrad_ab.py``,
in f32 and bf16, checked bitwise against the plain version, and timed
from CUDA graphs over input copies past the L2 (``chip_smoke.rotating``).
Variants (text substitutions of the source; every one computes the same
bits):

* ``base``: the source as it is;
* ``ahead2`` / ``ahead6`` / ``ahead8``: load batches of 2 / 6 / 8 rows
  (the source: 4);
* ``ahead12`` / ``ahead16``: batches of 12 / 16 rows;
* ``ahead8_cw``: ``ahead8`` with the blocks in channel-warp-major order
  (the runs of one channel warp consecutive; the source: run-major);
* ``ahead8_lb16``: ``ahead8`` with 16 resident warps an SM in the
  launch bounds (the source: 12);
* ``stcs``: the output stored with ``__stcs`` (evict-first);
* ``cs``: ``stcs`` and the rows loaded with ``__ldcs``.

Prints one JSON line a variant.  Its text anchors are those of the
source it was written for; where one is gone, it says so and exits.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "conv1d_fwd_ablation"
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "trim_conv1d.cu"

AHEAD = "constexpr int kAhead = 4;"
RUN_MAJOR = ("  const int run = blockIdx.x / a.d_warps;\n"
             "  c = (blockIdx.x - run * a.d_warps) * (kLanes * V) + "
             "threadIdx.x * V;")
CHANNEL_MAJOR = ("  const int runs = (a.length + a.tile_l - 1) / a.tile_l;\n"
                 "  const int cw = blockIdx.x / runs;\n"
                 "  const int run = blockIdx.x - cw * runs;\n"
                 "  c = cw * (kLanes * V) + threadIdx.x * V;")
BOUNDS = "constexpr int kMinBlocks = 12;"
STORES = [("*reinterpret_cast<float4 *>(p) = make_float4(v[0], v[1], v[2], "
           "v[3]);",
           "__stcs(reinterpret_cast<float4 *>(p), make_float4(v[0], v[1], "
           "v[2], v[3]));"),
          ("*reinterpret_cast<uint4 *>(p) = make_uint4(w[0], w[1], w[2], "
           "w[3]);",
           "__stcs(reinterpret_cast<uint4 *>(p), make_uint4(w[0], w[1], "
           "w[2], w[3]));")]
LOADS = [("return __ldg(reinterpret_cast<const float4 *>(p));",
          "return __ldcs(reinterpret_cast<const float4 *>(p));"),
         ("return __ldg(reinterpret_cast<const uint4 *>(p));",
          "return __ldcs(reinterpret_cast<const uint4 *>(p));")]
VARIANTS = {
    "base": [],
    "ahead2": [(AHEAD, "constexpr int kAhead = 2;")],
    "ahead6": [(AHEAD, "constexpr int kAhead = 6;")],
    "ahead8": [(AHEAD, "constexpr int kAhead = 8;")],
    "ahead12": [(AHEAD, "constexpr int kAhead = 12;")],
    "ahead16": [(AHEAD, "constexpr int kAhead = 16;")],
    "ahead8_cw": [(AHEAD, "constexpr int kAhead = 8;"),
                  (RUN_MAJOR, CHANNEL_MAJOR)],
    "ahead8_lb16": [(AHEAD, "constexpr int kAhead = 8;"),
                    (BOUNDS, "constexpr int kMinBlocks = 16;")],
    "stcs": STORES,
    "cs": STORES + LOADS,
}


def build_variants(names, nvcc, nvcc_flags) -> dict:
    """{name: (ctypes library, ptxas lines)}: each variant's source
    written and built, all ``nvcc`` started together."""
    src = SRC.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                sys.exit(f"variant {name}: anchor {old!r} is gone from "
                         f"{SRC}")
            text = text.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        lib = OUT / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *nvcc_flags, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        libs[name] = (ctypes.CDLL(str(lib)), ptxas_table(log))
    return libs


def ptxas_table(log: str) -> dict:
    """{"f32 K4 V4": "88 registers, 0 spill", ...} of the register-window
    instances, from ``nvcc -Xptxas -v``'s output."""
    table, inst = {}, None
    for line in log.splitlines():
        m = re.search(r"trim_conv1d_kernelI(f|13__nv_bfloat16)Li(\d+)ELi"
                      r"(\d+)E", line)
        if "Compiling entry function" in line:
            inst = m and (f"{'f32' if m.group(1) == 'f' else 'bf16'} "
                          f"K{m.group(2)} V{m.group(3)}")
        elif inst and "spill stores" in line:
            table[inst] = line.split(",")[1].strip()
        elif inst and "registers" in line:
            table[inst] = (line.split("Used")[1].split(",")[0].strip()
                           + ", " + table.get(inst, ""))
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--tile-ls", default="256,128,64,32,16")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.conv_plan import Conv1dPlan
    from repro_torch.kernels import build
    from repro_torch.kernels import trim_conv1d as tc1
    names = args.variants.split(",")
    libs = build_variants(names, build.nvcc(), build.NVCC_FLAGS)
    for lib, _ in libs.values():
        for fn in ("trim_conv1d_f32", "trim_conv1d_bf16"):
            getattr(lib, fn).argtypes = build.SOURCES["trim_conv1d"][fn]
            getattr(lib, fn).restype = ctypes.c_int
    tile_ls = [int(t) for t in args.tile_ls.split(",")]
    rows = [("fwd", r) for r in smoke.conv1d_fwd_rows()] + [
        ("dx", r) for r in smoke.conv1d_wgrad_rows()]
    gen = torch.Generator(device="cuda").manual_seed(35)
    out = {name: [] for name in names}
    for part, (case, b, length, d, k, strided) in rows:
        for dt in (torch.float32, torch.bfloat16):
            strided = strided and part == "fwd"
            xz = torch.randn((b, length, 2 * d if strided else d),
                             generator=gen, device="cuda").to(dt)
            x = xz[..., :d]
            w = (0.5 * torch.randn((k, d), generator=gen,
                                   device="cuda")).to(dt)
            reverse = part == "dx"
            want = (tc1.trim_conv1d_input_grad_plain(x, w) if reverse
                    else tc1.trim_conv1d_plain(x, w))
            vec = tc1.plan_for(x, w).vec
            for tile_l in tile_ls:
                plan = Conv1dPlan.build(tuple(x.shape), tuple(w.shape),
                                        tile_l=tile_l,
                                        dtype_bytes=x.element_size(),
                                        vec=vec)
                for name in names:
                    lib = libs[name][0]
                    entry = (lib.trim_conv1d_bf16 if dt == torch.bfloat16
                             else lib.trim_conv1d_f32)

                    def call(xc, wc, entry=entry, plan=plan):
                        y = torch.empty(tuple(xc.shape), dtype=dt,
                                        device="cuda")
                        err = entry(*tc1._launch_args(
                            xc, wc, y, plan, reverse=reverse),
                            torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"{name}: CUDA error {err}")
                        return y
                    got = call(x, w)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"{name} {case} {dt} "
                                             f"tile_l={tile_l}: not bitwise")
                    ms = smoke.rotating_ms(
                        torch, call, [x, w],
                        b * length * d * x.element_size())
                    out[name].append(dict(
                        part=part, case=case, dtype=str(dt).split(".")[1],
                        tile_l=tile_l, ms=ms,
                        of_bound=plan.bound()[0] / ms))
            del xz, x, w, want
            torch.cuda.empty_cache()
    for name in names:
        print(json.dumps({"variant": name, "card": smoke.card(),
                          "ptxas": libs[name][1], "rows": out[name]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
