"""Time one checkout's conv1d weight-gradient kernel the way
``chip_smoke.check_conv1d_wgrad`` times it, to compare two designs in one
call on the card.

    python3 tools/conv1d_wgrad_ab.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory of the checkout to measure (default:
this one's).  Its ``repro_torch`` builds its own kernel into its own
``build/`` at first use.  At recurrentgemma-2b's and falcon-mamba-7b's
training rows (``chip_smoke.conv1d_wgrad_rows``), in f32 and, where that
checkout's wrapper takes it, bf16, it prints one JSON line of:

* ``graph_ms``: device time from CUDA graphs over copies of x and dy
  that outgrow the L2 (``chip_smoke.rotating``);
* ``events_ms``: CUDA events around 20 back-to-back wrapper calls on one
  x and dy, the timing of the earlier PRs (a wrapper slower on the host
  than its kernel on the card reads its host time here);
* ``host_us``: the wrapper's host time a call (``chip_smoke.host_us``).

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
    rows = []
    for name, b, length, d, k, strided in smoke.conv1d_wgrad_rows():
        for dt in (torch.float32, torch.bfloat16):
            xz = torch.randn((b, length, 2 * d if strided else d),
                             generator=gen, device="cuda").to(dt)
            x = xz[..., :d]
            dy = torch.randn((b, length, d), generator=gen,
                             device="cuda").to(dt)
            try:
                tc1.trim_conv1d_weight_grad(x, dy, k)
            except ValueError:      # an f32-only wrapper
                continue

            def copy():
                cx, cy = xz.clone()[..., :d], dy.clone()
                return lambda: tc1.trim_conv1d_weight_grad(cx, cy, k)
            one = 2 * x.numel() * x.element_size()
            rows.append(dict(
                case=name, dtype=str(dt).split(".")[1],
                graph_ms=smoke.time_graph_ms(
                    torch, smoke.rotating(copy, one), reps=20),
                events_ms=smoke.time_ms(
                    torch, lambda: tc1.trim_conv1d_weight_grad(x, dy, k),
                    reps=20),
                host_us=smoke.host_us(
                    torch, lambda: tc1.trim_conv1d_weight_grad(x, dy, k))))
            del xz, x, dy
            torch.cuda.empty_cache()
    print(json.dumps({"label": args.label or args.src,
                      "card": smoke.card(), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
