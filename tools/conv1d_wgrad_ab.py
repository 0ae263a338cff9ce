"""Time one checkout's conv1d kernels the way ``chip_smoke.py`` times them,
to compare two designs in one call on the card: the forward kernel at the
prefill rows, its input gradient (the forward kernel on the reversed
cotangent) and the weight-gradient kernel at the training rows.

    python3 tools/conv1d_wgrad_ab.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory of the checkout to measure (default:
this one's).  Its ``repro_torch`` builds its own kernels into its own
``build/`` at first use.  The rows, in f32 and, where that checkout's
wrappers take it, bf16:

* ``fwd``: ``trim_conv1d`` at falcon-mamba-7b's and recurrentgemma-2b's
  prefill rows (``chip_smoke.conv1d_fwd_rows``: (a) the mixer's strided
  view (2, 2048, 8192, 4), (b) (2, 4096, 2560, 4));
* ``dx``: ``trim_conv1d_input_grad`` and ``dw``:
  ``trim_conv1d_weight_grad`` at the training rows
  (``chip_smoke.conv1d_wgrad_rows``: (c) recurrentgemma-2b's (1, 4096,
  2560, 4), (d) falcon-mamba-7b's (2, 1024, 8192, 4) view).

It prints one JSON line, each row with:

* ``graph_ms``: device time from CUDA graphs over copies of the inputs
  that outgrow the L2 (``chip_smoke.rotating``);
* ``events_ms``: CUDA events around 20 back-to-back wrapper calls on one
  set of inputs, the timing of the earlier PRs (a wrapper slower on the
  host than its kernel on the card reads its host time here);
* ``host_us``: the wrapper's host time a call (``chip_smoke.host_us``);
* ``bound_ms`` and ``of_bound``: the least bytes (each input read once,
  the output written once) at 3.35 TB/s, and that over ``graph_ms``.

To compare two commits, unpack the other into a gitignored directory
(``git archive <commit> | tar -x -C build/parent``) and run this script
on each in turn, parent, change, change, parent, each in its own
process.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import trim_conv1d as tc1
    gen = torch.Generator(device="cuda").manual_seed(34)
    parts = [("fwd", r) for r in smoke.conv1d_fwd_rows()] + [
        (part, r) for r in smoke.conv1d_wgrad_rows() for part in ("dx",
                                                                 "dw")]
    rows = []
    for part, (name, b, length, d, k, strided) in parts:
        for dt in (torch.float32, torch.bfloat16):
            xz = torch.randn((b, length, 2 * d if strided else d),
                             generator=gen, device="cuda").to(dt)
            dy = torch.randn((b, length, d), generator=gen,
                             device="cuda").to(dt)
            w = (0.5 * torch.randn((k, d), generator=gen,
                                   device="cuda")).to(dt)

            def call(xz, dy):
                if part == "fwd":
                    return lambda: tc1.trim_conv1d(xz[..., :d], w)
                if part == "dx":
                    return lambda: tc1.trim_conv1d_input_grad(dy, w)
                return lambda: tc1.trim_conv1d_weight_grad(xz[..., :d],
                                                           dy, k)
            try:
                call(xz, dy)()
            except ValueError:      # an f32-only wrapper
                continue
            e = xz.element_size()
            # the bytes each call must move, and one copy's for rotating
            least = e * (2 * b * length * d + k * d)
            held = {"fwd": xz.numel() * e + b * length * d * e,
                    "dx": 2 * dy.numel() * e,
                    "dw": (xz.numel() + dy.numel()) * e}[part]

            def copy():
                return call(xz.clone(), dy.clone())
            ms = smoke.time_graph_ms(torch, smoke.rotating(copy, held),
                                     reps=20)
            bound = least / smoke.PEAK_BYTES_PER_S * 1e3
            rows.append(dict(
                part=part, case=name, dtype=str(dt).split(".")[1],
                graph_ms=ms,
                events_ms=smoke.time_ms(torch, call(xz, dy), reps=20),
                host_us=smoke.host_us(torch, call(xz, dy)),
                bound_ms=bound, of_bound=bound / ms))
            del xz, dy, w
            torch.cuda.empty_cache()
    print(json.dumps({"label": args.label or args.src,
                      "card": smoke.card(), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
