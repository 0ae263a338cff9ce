#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (``src/repro_torch``).

Run from the repository root on a host with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each raising on failure:

1. device — the card's name and power limit (``nvidia-smi``);
2. build  — a fresh ``nvcc`` build of every kernel source for sm_90a;
3. kernel check — each conv kernel (carry, halo) against its plain PyTorch
   version at the shapes of full-width VGG-16 (all 13 layers, batch 8),
   plus one stride-2 and one depthwise case: max-abs error within
   1e-4 * max(1, max|plain|) (sums of up to 4,608 f32 terms taken in
   another order), carry == halo bitwise, and each one's time beside the
   plain version's, ``F.conv2d``'s (TF32 off) and the card's bound;
4. serve — full-width VGG-16 (1000 classes, seeded random weights) served
   through ``ServingEngine`` on buckets (1, 2, 4, 8): a seeded Poisson
   trace on the carry kernel, then part of it on the halo kernel; every
   served row must bit-match ``forward_one``, the launch counts must rise
   by 13 per forward, and one image's logits must agree with the
   ``impl="ref"`` oracle;
5. the kernel JSON line, then ``{"ok": true, "device": ...}`` last.

Exits non-zero without a result when no GPU is visible.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_F32_FLOPS = 67e12      # H100 SXM: f32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM: HBM3
TOLERANCE = 1e-4            # of max(1, max|plain|); see the docstring
REQUESTS = 48               # carry-kernel serving trace
HALO_REQUESTS = 16          # halo-kernel serving trace (a prefix of it)
ARRIVAL_RATE = 200.0        # requests per second (Poisson)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` launches after a warm-up
    (CUDA events; L2 not flushed between launches)."""
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


def kernel_cases():
    """(name, x_shape, w_shape, stride, groups): VGG-16 at batch 8, then
    the extra stride-2 and depthwise cases."""
    from repro_torch.core.model import vgg16_layers
    cases = [(l.name, (8, l.ifmap, l.ifmap, l.in_channels),
              (3, 3, l.in_channels, l.out_channels), 1, 1)
             for l in vgg16_layers()]
    cases.append(("s2_56x128", (8, 56, 56, 128), (3, 3, 128, 256), 2, 1))
    cases.append(("dw_112x32", (8, 112, 112, 32), (3, 3, 1, 32), 1, 32))
    return cases


def check_kernels(torch):
    import torch.nn.functional as F
    from repro_torch.core.conv_plan import ConvPlan
    from repro_torch.kernels.ref import conv_pads, pad_nhwc
    from repro_torch.kernels.trim_conv2d import (trim_conv2d,
                                                 trim_conv2d_plain)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    print("kernel check (relu, bias, 'same'; times in ms, device events):")
    print(f"  {'case':10s} {'max_err':>9s} {'tol':>8s} {'c==h':>5s} "
          f"{'carry':>8s} {'halo':>8s} {'plain':>8s} {'F.conv':>8s} "
          f"{'bound':>8s} by")
    for name, xs, wsh, stride, groups in kernel_cases():
        k = wsh[0]
        x = torch.randn(xs, generator=gen, device="cuda")
        w = torch.randn(wsh, generator=gen, device="cuda") \
            / float(np.sqrt(k * k * wsh[2]))
        b = torch.randn((wsh[3],), generator=gen, device="cuda")
        pads = conv_pads(xs[1], xs[2], k, stride, "same")
        kw = dict(stride=stride, pad=pads, groups=groups, activation="relu")
        plain = trim_conv2d_plain(x, w, b, **kw)
        carry = trim_conv2d(x, w, b, dataflow="carry", **kw)
        halo = trim_conv2d(x, w, b, dataflow="halo", **kw)
        torch.cuda.synchronize()
        scale = max(1.0, plain.abs().max().item())
        err = max((carry - plain).abs().max().item(),
                  (halo - plain).abs().max().item())
        same = torch.equal(carry, halo)
        if not np.isfinite(err) or err > TOLERANCE * scale:
            raise AssertionError(f"{name}: max|kernel - plain| = {err} > "
                                 f"{TOLERANCE} * {scale}")
        if not same:
            raise AssertionError(f"{name}: carry and halo differ bitwise")
        xp = pad_nhwc(x, pads).permute(0, 3, 1, 2)
        wl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        t = {
            "carry": time_ms(torch, lambda: trim_conv2d(
                x, w, b, dataflow="carry", **kw)),
            "halo": time_ms(torch, lambda: trim_conv2d(
                x, w, b, dataflow="halo", **kw)),
            "plain": time_ms(torch, lambda: trim_conv2d_plain(x, w, b, **kw)),
            # one library call: conv + bias (the relu is not in it)
            "library": time_ms(torch, lambda: F.conv2d(
                xp, wl, b, stride=stride, groups=groups)),
        }
        plan = ConvPlan.build(xs, wsh, stride=stride, pad=pads,
                              groups=groups)
        ops_ms = plan.flops / PEAK_F32_FLOPS * 1e3
        bytes_ms = plan.min_bytes() / PEAK_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        rows.append(dict(name=name, err=err, bound=bound, by=by,
                         ops_ms=ops_ms, bytes_ms=bytes_ms,
                         vgg=name.startswith("conv"), **t))
        print(f"  {name:10s} {err:9.2e} {TOLERANCE * scale:8.1e} "
              f"{str(same):>5s} {t['carry']:8.3f} {t['halo']:8.3f} "
              f"{t['plain']:8.3f} {t['library']:8.3f} {bound:8.3f} {by}")
        del x, w, b, plain, carry, halo, xp, wl
    torch.cuda.empty_cache()
    return rows


def serve(n_requests, dataflow, model, xs, expect=None):
    """Replay a seeded Poisson trace through the serving engine on one
    dataflow; return (results, launches, forwards)."""
    from repro_torch.core.model import vgg16_layers
    from repro_torch.core.serving import ServingEngine, replay
    from repro_torch.kernels import trim_conv2d as tc
    from repro_torch.models.layers import TrimCNN
    from repro_torch.testing.load import poisson_arrivals

    topo = vgg16_layers()
    served = TrimCNN(topo, model.tree(), dataflow=dataflow)
    engine = ServingEngine.for_topology(topo, served, buckets=(1, 2, 4, 8),
                                        device="cuda")
    t0 = time.perf_counter()
    warm = engine.prewarm()
    print(f"serve[{dataflow}]: prewarm {time.perf_counter() - t0:.3f} s "
          f"(first forward per bucket, s: "
          f"{ {b: round(s, 4) for b, s in warm.items()} })")
    trace = [(t, i, xs[i]) for i, t in enumerate(
        poisson_arrivals(ARRIVAL_RATE, n_requests, seed=0))]
    tc.reset_launch_counts()
    results, rejected = replay(engine, trace)
    launches = dict(tc.LAUNCHES)
    st = engine.stats()
    forwards = sum(st["bucket_batches"].values())
    if rejected or len(results) != n_requests:
        raise AssertionError(f"served {len(results)}/{n_requests}, "
                             f"rejected {rejected}")
    other = "halo" if dataflow == "carry" else "carry"
    if launches[dataflow] != 13 * forwards or launches[other] != 0:
        raise AssertionError(f"launches {launches} for {forwards} forwards "
                             f"of 13 convs on {dataflow}")
    s = engine.recorder.summary()
    print(f"serve[{dataflow}]: {len(results)} requests, rejected 0, "
          f"bucket batches {st['bucket_batches']}, {forwards} forwards, "
          f"launches {launches} (13 per forward); p50 "
          f"{s['p50_s'] * 1e3:.3f} ms, p99 {s['p99_s'] * 1e3:.3f} ms, "
          f"throughput {s['throughput_rps']:.1f} req/s "
          f"(measured service times on an arrival trace at "
          f"{ARRIVAL_RATE:g} req/s)")
    for i in range(n_requests):
        row = results[i]
        ref = engine.forward_one(xs[i]) if expect is None else expect[i]
        if row.shape != (1000,) or not np.isfinite(row).all():
            raise AssertionError(f"request {i}: bad logits {row.shape}")
        if not np.array_equal(row, ref):
            raise AssertionError(f"request {i}: served row differs from "
                                 "the single-request forward")
    print(f"serve[{dataflow}]: all {n_requests} served rows bit-match "
          + ("forward_one" if expect is None else "the carry rows"))
    return results, launches[dataflow], forwards


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.model import vgg16_layers
    from repro_torch.kernels import build
    from repro_torch.models.layers import TrimCNN

    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    print(card())

    t0 = time.perf_counter()
    build.build_all(rebuild=True)
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for src, log in build.build_log.items():
        print(f"  {src}: {log['command']}")
        for line in log["ptxas"]:
            print(f"    {line.strip()}")

    rows = check_kernels(torch)

    rng = np.random.default_rng(0)
    xs = rng.standard_normal((REQUESTS, 224, 224, 3)).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    model = TrimCNN.random(vgg16_layers(), n_classes=1000, seed=0,
                           device="cuda")
    carry_rows, carry_launches, carry_fw = serve(REQUESTS, "carry", model,
                                                 xs)
    _, halo_launches, halo_fw = serve(HALO_REQUESTS, "halo", model, xs,
                                      expect=carry_rows)
    with torch.inference_mode():
        oracle = TrimCNN(vgg16_layers(), model.tree(), impl="ref")(
            torch.from_numpy(xs[:1]).cuda()).cpu().numpy()[0]
    diff = float(np.abs(oracle - carry_rows[0]).max())
    lim = TOLERANCE * max(1.0, float(np.abs(oracle).max()))
    if not diff <= lim:
        raise AssertionError(f"logits vs impl='ref': {diff} > {lim}")
    print(f"serve: request 0 logits vs impl='ref' oracle: max|diff| "
          f"{diff:.3e} <= {lim:.1e}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    vgg = [r for r in rows if r["vgg"]]
    kernels = []
    for df, launches, src_line in (("carry", carry_launches, 127),
                                   ("halo", halo_launches, 162)):
        ops_ms = sum(r["ops_ms"] for r in vgg if r["by"] == "operations")
        bytes_ms = sum(r["bytes_ms"] for r in vgg if r["by"] == "bytes")
        kernels.append({
            "name": f"trim_conv2d_{df}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/trim_conv2d.cu",
            "replaces": f"src/repro/kernels/trim_conv2d.py:{src_line}",
            "launches": launches,
            "max_abs_err": max(r["err"] for r in rows),
            "ms": sum(r[df] for r in vgg),
            "plain_ms": sum(r["plain"] for r in vgg),
            "bound_ms": sum(r["bound"] for r in vgg),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": sum(r["library"] for r in vgg),
        })
    print("kernel times: sums over the 13 VGG-16 conv layers at batch 8; "
          f"launches from the serving runs ({carry_fw} carry forwards, "
          f"{halo_fw} halo forwards)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
