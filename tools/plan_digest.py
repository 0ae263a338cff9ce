#!/usr/bin/env python3
"""Print every conv plan of a fixed set of geometries as JSON lines, to
compare two checkouts' planners (``diff`` of the outputs).

    python3 tools/plan_digest.py > plans.jsonl

The set: each geometry of ``tests/test_torch_conv_plan.py``'s ``SWEEP``
(``ConvPlan`` carry and halo in f32, carry in int8, and ``WeightGradPlan``),
full-width VGG-16 and AlexNet at batch 1-8 (the forward plans of both
dataflows, the input-gradient plans, ``WeightGradPlan``) and the
``FusedGroupPlan`` of full-width VGG-16, VGG-16 at 1/16 width and AlexNet at
batch 1-8.  A plan is printed as its dataclass fields and every property
(``min_bytes`` and ``hbm_bytes`` too); a square kernel's extent is printed
as ``kernel: [K, K]`` whether the plan names it ``k`` or ``kh`` / ``kw``.
The last line is the count of plans.  Runs on the CPU, in seconds.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]

from repro_torch.core.conv_plan import (ConvPlan, WeightGradPlan,  # noqa
                                        input_grad_geometry)
from repro_torch.core.fuse_plan import FusedGroupPlan  # noqa: E402
from repro_torch.core.model import alexnet_layers, vgg16_layers  # noqa
from repro_torch.core.netplan import scale_layers  # noqa: E402
from repro_torch.kernels.ref import conv_pads  # noqa: E402
from test_torch_conv_plan import SWEEP  # noqa: E402


def plan_dict(p) -> dict:
    out = {}
    for f in dataclasses.fields(p):
        out[f.name] = getattr(p, f.name)
    if "k" in out:
        out["kernel"] = [out.pop("k")] * 2
    elif "kh" in out:
        out["kernel"] = [out.pop("kh"), out.pop("kw")]
    cls = type(p)
    for name in sorted(dir(cls)):
        if isinstance(getattr(cls, name, None), property):
            try:
                out[name] = getattr(p, name)
            except Exception as e:          # a property a route lacks
                out[name] = f"raises {type(e).__name__}"
    for name in ("min_bytes", "hbm_bytes"):
        if hasattr(p, name):
            out[name] = getattr(p, name)()
    return out


def emit(key, p) -> None:
    print(json.dumps({"key": key, "plan": plan_dict(p)}, sort_keys=True,
                     default=str))


def main() -> None:
    count = 0
    for i, case in enumerate(SWEEP):
        n, h, w, cin, cout, k, s, g, padding, tile_h, tile_cout = case
        xs, ws = (n, h, w, cin), (k, k, cin // g, cout)
        pads = conv_pads(h, w, k, s, padding)
        kw = dict(stride=s, pad=pads, groups=g, tile_h=tile_h,
                  tile_cout=tile_cout)
        for df in ("carry", "halo"):
            emit(f"sweep{i}:{df}", ConvPlan.build(xs, ws, dataflow=df, **kw))
            count += 1
        try:
            q8 = ConvPlan.build(xs, ws, dtype_bytes=1, **kw)
        except ValueError as e:
            print(json.dumps({"key": f"sweep{i}:q8", "raises": str(e)}))
        else:
            emit(f"sweep{i}:q8", q8)
        count += 1
        emit(f"sweep{i}:wgrad", WeightGradPlan.build(xs, ws, stride=s,
                                                     pad=pads, groups=g))
        count += 1
    for net, layers in (("vgg16", vgg16_layers()),
                        ("alexnet", alexnet_layers())):
        for n in range(1, 9):
            for l in layers:
                padding = "same" if l.padding else "valid"
                xs = (n, l.ifmap, l.ifmap, l.in_channels)
                ws = (l.kernel, l.kernel, l.in_channels // l.groups,
                      l.out_channels)
                pads = conv_pads(l.ifmap, l.ifmap, l.kernel, l.stride,
                                 padding)
                kw = dict(stride=l.stride, pad=pads, groups=l.groups)
                key = f"{net}:{l.name}:n{n}"
                for df in ("carry", "halo"):
                    emit(f"{key}:{df}", ConvPlan.build(xs, ws, dataflow=df,
                                                       **kw))
                geo = input_grad_geometry(xs, ws, **kw)
                emit(f"{key}:dx", ConvPlan.build(
                    geo["g_dilated_shape"], geo["wt_shape"],
                    pad=(geo["pad_h"], geo["pad_w"]), groups=l.groups))
                emit(f"{key}:wgrad", WeightGradPlan.build(xs, ws, **kw))
                count += 4
    for net, layers in (("vgg16", vgg16_layers()),
                        ("vgg16/16", scale_layers(vgg16_layers(), 16)),
                        ("alexnet", alexnet_layers())):
        for n in range(1, 9):
            fp = FusedGroupPlan.build(layers, n=n)
            print(json.dumps({"key": f"fused:{net}:n{n}",
                              "describe": fp.describe(),
                              "groups": [dataclasses.asdict(g)
                                         for g in fp.groups],
                              "layer_exec_bytes": fp.layer_exec_bytes},
                             sort_keys=True, default=str))
            count += 1
    print(json.dumps({"plans": count}))


if __name__ == "__main__":
    main()
