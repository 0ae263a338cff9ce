#!/usr/bin/env python3
"""Where the flash backward kernels' time goes, on a card without ``ncu``.

Run from the repository root on a host with one NVIDIA GPU:

    python3 tools/flash_bwd_ablation.py [--turns 3]

Copies of ``csrc/flash_attention_bwd.cu`` with one thing changed are built
with ``nvcc`` beside the real one (``build/flash_bwd_ablation/``) and the
dQ and dK/dV kernels of each are timed (CUDA events, 20 launches, the
median of ``--turns`` alternating rounds) at the LM training shape (t)
and recurrentgemma-2b's (c), with ptxas's registers and spills and each
variant's error against the plain backward.  Variants:

* ``base``: the source as it is;
* ``unroll1`` / ``unroll4``: the score loop over D unrolled 1 / 4 times
  (the source: 2; the arithmetic is the same, bit for bit);
* ``tf32x1``: one TF32 product where 3xTF32 takes three (TF32 accuracy:
  its errors are ~1e-3, its time what the split and the two small
  products cost);
* ``no_mma``: every ``mma.sync`` replaced by one integer op on its
  operands (garbage numbers; the time of everything but the tensor
  cores: loads, splits, exp, barriers).

A one-off: it recorded where PR 26's kernels spend their time (PERF.md
§6).  Its text anchors are those of that source and bind no later edit of
the kernel; where one is gone, the tool says so and exits, and a later
diagnosis writes its own variants.  Prints a table and one JSON line.
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
OUT = os.path.join(ROOT, "build", "flash_bwd_ablation")

UNROLL = "#pragma unroll 2\n  for (int d0 = 0; d0 < kDp; d0 += 16) {"
SCORE_MMA = """        if (kYFirst) {
          mma_tf32(t, ab[h], bs);
          mma_tf32(t, as[h], bb);
          mma_tf32(t, ab[h], bb);
        } else {
          mma_3xtf32(t, t, ab[h], as[h], bb, bs);
        }"""
ACC_MMA = "      mma_3xtf32(t, tc, pb[j], ps[j], bb, bs);"
HEADER = '#include "tf32_mma.cuh"\n'
ASM = """  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));"""
NO_ASM = ("  d[0] += __uint_as_float((a[0] ^ b[0]) & 0x3fffffffu);\n"
          "  d[1] += __uint_as_float((a[1] ^ b[1]) & 0x3fffffffu);\n"
          "  d[2] += __uint_as_float((a[2] ^ b[0]) & 0x3fffffffu);\n"
          "  d[3] += __uint_as_float((a[3] ^ b[1]) & 0x3fffffffu);")
# (name, b, lq, lk, hq, hkv, d, causal, soft_cap, window)
CASES = [("t_train", 2, 1024, 1024, 16, 2, 128, True, None, None),
         ("c_rgemma", 1, 4096, 4096, 10, 1, 256, True, 30.0, 2048)]


def sub(text, old, new):
    if old not in text:
        sys.exit("flash_bwd_ablation: the kernel source has moved on from "
                 f"the one these variants were written for ({old[:40]!r} "
                 "is gone)")
    return text.replace(old, new)


def variants(src: str, header: str) -> dict:
    inline = sub(src, HEADER, header.replace("#pragma once\n", ""))
    return {
        "base": src,
        "unroll1": sub(src, UNROLL, UNROLL.replace("unroll 2", "unroll 1")),
        "unroll4": sub(src, UNROLL, UNROLL.replace("unroll 2", "unroll 4")),
        "tf32x1": sub(sub(src, SCORE_MMA, "        mma_tf32(t, ab[h], bb);"),
                      ACC_MMA, "      mma_tf32(t, pb[j], bb);"),
        "no_mma": sub(inline, ASM, NO_ASM),
    }


def build_all(names_src: dict) -> dict:
    from repro_torch.kernels import build
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in names_src.items():
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(OUT, f"lib{name}.so")
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
               so, cu]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs, regs = {}, {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs[name] = [ln.split(":")[-1].strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln]
        lib = ctypes.CDLL(so)
        for fn, argtypes in build.SOURCES["flash_attention_bwd"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        err = lib.flash_attention_bwd_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        libs[name] = lib
    return libs, regs


def time_ms(torch, fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_ablation: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    with open(os.path.join(build.CSRC, "flash_attention_bwd.cu")) as f:
        src = f.read()
    with open(os.path.join(build.CSRC, "tf32_mma.cuh")) as f:
        header = f.read()
    libs, regs = build_all(variants(src, header))
    gen = torch.Generator(device="cuda").manual_seed(11)
    result = {"card": card, "regs": regs, "cases": {}}
    for name, b, lq, lk, hq, hkv, d, causal, cap, win in CASES:
        q, do = (torch.randn((b, lq, hq, d), generator=gen, device="cuda")
                 for _ in range(2))
        k, v = (torch.randn((b, lk, hkv, d), generator=gen, device="cuda")
                for _ in range(2))
        kw = dict(causal=causal, soft_cap=cap, window=win)
        lse = torch.empty((b, hq, lq), device="cuda")
        fa._launch_forward(q, k, v, causal, cap, win, lse)
        plain = fa.flash_attention_backward_plain(q, k, v, lse, do, **kw)
        plan = fa.bwd_plan(b, lq, lk, hq, hkv, d)
        stats = torch.empty((2, b, hq, lq), device="cuda")
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        part = torch.empty((2, plan.group, *k.shape), device="cuda")
        outs = (dk, dv) if plan.group == 1 else (part[0], part[1])
        times = {var: {"dq": [], "dkdv": []} for var in libs}
        errs = {}
        for turn in range(args.turns):
            for var, lib in libs.items():
                build._libs["flash_attention_bwd"] = lib
                if turn == 0:
                    got = fa.flash_attention_backward(q, k, v, lse, do, **kw)
                    errs[var] = max(((g - p).abs().max() / p.abs().max())
                                    .item() for g, p in zip(got, plain))
                times[var]["dq"].append(time_ms(torch, lambda: (
                    fa._launch_backward("dq", q, k, v, do, lse, stats, (dq,),
                                        plan=plan, **kw))))
                times[var]["dkdv"].append(time_ms(torch, lambda: (
                    fa._launch_backward("dkdv", q, k, v, do, lse, stats, outs,
                                        plan=plan, **kw))))
        build._libs.pop("flash_attention_bwd", None)
        med = {var: {p: statistics.median(t) for p, t in ts.items()}
               for var, ts in times.items()}
        result["cases"][name] = {"ms": med, "err": errs}
        print(f"{name} ({card}): ms, median of {args.turns} turns")
        print(f"  {'variant':8s} {'dq':>8s} {'dkdv':>8s} {'err':>9s}")
        for var in libs:
            print(f"  {var:8s} {med[var]['dq']:8.3f} {med[var]['dkdv']:8.3f} "
                  f"{errs[var]:9.2e}")
        del q, k, v, do, lse, plain, stats, dq, dk, dv, part
        torch.cuda.empty_cache()
    for var, r in regs.items():
        print(f"  ptxas {var}: " + "; ".join(r))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
