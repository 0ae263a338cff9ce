#!/usr/bin/env python3
"""Time the candidate tiles of the bf16 tensor-core conv route on the card,
and rank them by the planner's clock model.

On a host with one H100 (the sweep, ~90 s; one JSON line a candidate):

    python3 tools/bf16_tile_sweep.py --out chiprun_out/bf16_tiles.jsonl

Anywhere, on that file (the fit):

    python3 tools/bf16_tile_sweep.py --fit chiprun_out/bf16_tiles.jsonl

The sweep: VGG-16's and AlexNet's route-mma layers (``conv_plan.
bf16_route``) at N 8, 4, 2 and 1; each layer's candidates are
``autotune.candidate_knobs``' carry plans at bf16, each timed from CUDA
graphs by ``autotune._measure_plan`` (3 turns).  A line holds the layer,
N, the plan's tile fields and its microseconds.

The fit: for each value of ``conv_plan.BF16_MMA_COPY_CLOCKS`` (the clock
model's weight-copy term a warp along C_out), the summed time of the plan
``_build_bf16_mma``'s key ranks first among each layer's measured
candidates, beside the measured best and the plan the file's own default
was (its first candidate).  The constant in ``core/conv_plan.py`` is a
value of this fit's flat region.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import autotune, conv_plan  # noqa: E402
from repro_torch.core.conv_plan import SMS, ConvPlan  # noqa: E402
from repro_torch.core.model import alexnet_layers, vgg16_layers  # noqa


def sweep(out: str) -> None:
    import tempfile

    import torch
    torch.backends.cudnn.allow_tf32 = False
    os.environ[autotune.CACHE_ENV] = os.path.join(tempfile.mkdtemp(),
                                                  "convtune.json")
    dev = torch.device("cuda")
    nets = (("vgg16", vgg16_layers()), ("alexnet", alexnet_layers()))
    with open(out, "w") as f:
        for net, layers in nets:
            for n in (8, 4, 2, 1):
                for l in layers:
                    if l.kernel > 8 or conv_plan.bf16_route(
                            l.in_channels // l.groups, l.groups) != "mma":
                        continue
                    xs, pads, ws = autotune.layer_problem(l, n=n)
                    cands = [(k, p) for k, p in autotune.candidate_knobs(
                        xs, ws, stride=l.stride, pad=pads, groups=l.groups,
                        dtype_bytes=2) if p.dataflow == "carry"]
                    us = autotune._measure_plan(
                        xs, ws, [k for k, _ in cands], stride=l.stride,
                        pad=pads, groups=l.groups, dtype="bfloat16",
                        device=dev, turns=3)
                    for (_, p), u in zip(cands, us):
                        f.write(json.dumps(dict(
                            net=net, n=n, layer=l.name, us=u, xs=xs, ws=ws,
                            stride=l.stride, pads=pads, groups=l.groups,
                            tile_h=p.tile_h, tile_w=p.tile_w,
                            tile_cout=p.tile_cout, warps_n=p.warps_n,
                            m_frags=p.m_frags, cin_stride=p.cin_stride))
                                + "\n")
                    print(f"{net} n{n} {l.name}: {len(cands)} candidates, "
                          f"default {us[0]:.1f} us, best {min(us):.1f} us",
                          flush=True)


def fit(path: str) -> None:
    probs = {}
    for line in open(path):
        r = json.loads(line)
        base = ConvPlan.build(tuple(r["xs"]), tuple(r["ws"]),
                              stride=r["stride"],
                              pad=tuple(map(tuple, r["pads"])),
                              groups=r.get("groups", 1), dtype_bytes=2)
        p = dataclasses.replace(
            base, **{k: r[k] for k in ("tile_h", "tile_w", "tile_cout",
                                       "warps_n", "m_frags", "cin_stride")})
        probs.setdefault((r["net"], r["n"], r["layer"]), []).append(
            (r["us"], p))

    def key(p):       # _build_bf16_mma's ranking
        clocks = (p.rounds * p.strips_per_segment
                  * conv_plan.mma_strip_clocks(p))
        read = p.window_rows * p.window_cols / (p.positions * p.tile_cout)
        return (p.blocks < SMS, clocks, read, -p.tile_w)

    def total(pick):
        sums = {}
        for (net, n, _), cands in probs.items():
            sums[(net, n)] = sums.get((net, n), 0.0) + pick(cands)
        return sums

    def show(label, sums):
        print(f"{label}: {sum(sums.values()):.1f} us; " + ", ".join(
            f"{net} N={n} {v:.1f}" for (net, n), v in sorted(sums.items())))
    show("the file's defaults", total(lambda c: c[0][0]))
    show("the measured best", total(lambda c: min(u for u, _ in c)))
    saved = conv_plan.BF16_MMA_COPY_CLOCKS
    for copy in (0.0, 50.0, 150.0, 225.0, 300.0, 450.0, 900.0, 1800.0):
        conv_plan.BF16_MMA_COPY_CLOCKS = copy
        show(f"copy clocks {copy:g}",
             total(lambda c: min(c, key=lambda t: key(t[1]))[0]))
    conv_plan.BF16_MMA_COPY_CLOCKS = saved


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="sweep on the card into this file")
    ap.add_argument("--fit", help="rank a sweep's candidates by the model")
    args = ap.parse_args()
    if args.out:
        sweep(args.out)
    if args.fit:
        fit(args.fit)
    if not (args.out or args.fit):
        ap.error("give --out (on the card) or --fit")


if __name__ == "__main__":
    main()
