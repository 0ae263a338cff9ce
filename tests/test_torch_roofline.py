"""The port's roofline (``core/roofline.py``), the one source of the H100
peaks, and the model-FLOP counts of ``configs/registry.py``.

* each peak constant is assigned once, in ``core/roofline.py``: no other
  module of the port and not ``chip_smoke.py`` assigns a ``PEAK_*``
  (an AST scan);
* ``RooflineTerms``, ``route_peak``, ``conv_plan_roofline``,
  ``sum_terms``, ``network_roofline`` and ``markdown_table`` on the
  port's plans; the parts that do not read a peak equal JAX's on the
  same inputs;
* ``model_flops`` (train, prefill, decode) and ``count_active_params``
  equal JAX's for all ten registered architectures at full width
  (declaration trees, nothing allocated).
"""

import ast
import dataclasses
import pathlib

import pytest

from repro.configs import registry as jreg
from repro.configs.shapes import ShapePlan
from repro.core import roofline as jrl
from repro_torch.configs import registry as treg
from repro_torch.core import conv_plan
from repro_torch.core import roofline as rl
from repro_torch.core.model import ConvLayer
from repro_torch.core.netplan import NetworkGraph, NetworkPlan

ROOT = pathlib.Path(__file__).resolve().parents[1]
PEAKS = {"PEAK_F32_FLOPS": 67e12, "PEAK_TF32_FLOPS": 495e12,
         "PEAK_BF16_FLOPS": 989e12, "PEAK_INT8_OPS": 1979e12,
         "PEAK_DP4A_OPS": 132 * 64 * 4 * 2 * 1.98e9,
         "PEAK_BYTES_PER_S": 3.35e12}


def _peak_assignments(path):
    """Names ``PEAK_*`` bound by an assignment in ``path``."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = [node.target]
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name) and n.id.startswith("PEAK_"):
                    out.append(n.id)
    return out


def test_each_peak_is_assigned_once_in_roofline():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    here = ROOT / "src" / "repro_torch" / "core" / "roofline.py"
    for path in files:
        if path != here:
            assert _peak_assignments(path) == [], path
    names = _peak_assignments(here)
    assert sorted(names) == sorted(PEAKS)
    for name, value in PEAKS.items():
        assert getattr(rl, name) == value
    # the plans read these very objects
    assert conv_plan.PEAK_F32_FLOPS is rl.PEAK_F32_FLOPS
    assert conv_plan.PEAK_BF16_FLOPS is rl.PEAK_BF16_FLOPS
    assert conv_plan.PEAK_BYTES_PER_S is rl.PEAK_BYTES_PER_S


@pytest.mark.parametrize("name,width", [
    ("f32", 4), ("float32", 4), ("bfloat16", 2), ("bf16", 2), ("int8", 1),
    ("s8", 1)])
def test_dtype_width_names_equal_jax(name, width):
    assert rl.dtype_width(name) == jrl.dtype_width(name) == width


def test_dtype_width_takes_torch_and_numpy_dtypes():
    import numpy as np
    import torch
    assert [rl.dtype_width(d) for d in (torch.float32, torch.bfloat16,
                                        torch.int8)] == [4, 2, 1]
    for d in (np.float32, np.dtype("int8")):
        assert rl.dtype_width(d) == jrl.dtype_width(d)


@pytest.mark.parametrize("name", ["float16", "float64", "int32", "bool",
                                  "f7"])
def test_dtype_width_refuses_a_type_the_port_does_not_run(name):
    with pytest.raises(ValueError, match="unknown dtype"):
        rl.dtype_width(name)


def test_route_peaks():
    assert rl.route_peak(4) == 67e12
    assert rl.route_peak(4, "tf32x3") == 495e12 / 3
    assert rl.route_peak(2, "mma") == 989e12
    assert rl.route_peak(2, "ffma") == 67e12
    assert rl.route_peak(1) == rl.route_peak(1, "mma") == 1979e12
    assert rl.route_peak(1, "dp4a") == rl.PEAK_DP4A_OPS
    with pytest.raises(ValueError):
        rl.route_peak(8)


@pytest.mark.parametrize("db,cin,groups,peak", [
    (4, 64, 1, 67e12), (2, 64, 1, 989e12), (2, 3, 1, 67e12),
    (1, 64, 1, 1979e12), (1, 32, 32, 132 * 64 * 4 * 2 * 1.98e9)])
def test_conv_plan_roofline_takes_the_route_s_peak(db, cin, groups, peak):
    layer = ConvLayer("x", 28, cin, cin if groups > 1 else 128, 3,
                      padding=1, groups=groups)
    plan = layer.plan(n=2, dtype_bytes=db)
    for mode in (None, "3dtrim", "trim"):
        t = rl.conv_plan_roofline("x", plan, mode)
        assert t.peak_flops == peak
        assert t.flops_per_dev == plan.flops
        assert t.hbm_bytes_per_dev == plan.hbm_bytes(mode)["total"]
        assert t.t_compute == plan.flops / peak
        assert t.t_memory == plan.hbm_bytes(mode)["total"] / 3.35e12
        assert t.peak_memory_bytes == plan.smem_bytes
        assert t.step_time_s == max(t.t_compute, t.t_memory)
        assert t.dominant == ("compute" if t.t_compute >= t.t_memory
                              else "memory")
        assert t.useful_flops_ratio == 1.0
        assert t.roofline_fraction == pytest.approx(
            t.t_compute / t.step_time_s, rel=1e-12)


def _twins(**kw):
    """The same terms in both packages (JAX's with no collective
    bytes, which one card does not have)."""
    peak = kw.pop("peak_flops", rl.PEAK_F32_FLOPS)
    return (rl.RooflineTerms(peak_flops=peak, **kw),
            jrl.RooflineTerms(coll_bytes_per_dev=0.0, coll_by_kind={},
                              **kw))


def test_terms_and_sum_terms_equal_jax_where_no_peak_is_read():
    rows = [dict(cell=f"c{i}", flops_per_dev=f, hbm_bytes_per_dev=b,
                 peak_memory_bytes=m, model_flops_per_dev=f * 0.5)
            for i, (f, b, m) in enumerate(
                [(1e12, 3e9, 1e6), (4e11, 9e9, 7e6), (0.0, 5e8, 2e5)])]
    peaks = (67e12, 989e12, 1979e12)
    pairs = [_twins(peak_flops=p, **r) for p, r in zip(peaks, rows)]
    t = rl.sum_terms("net", [a for a, _ in pairs])
    j = jrl.sum_terms("net", [b for _, b in pairs])
    for f in ("flops_per_dev", "hbm_bytes_per_dev", "peak_memory_bytes",
              "model_flops_per_dev"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.useful_flops_ratio == j.useful_flops_ratio
    # kernels on different routes keep their own compute times
    assert t.t_compute == pytest.approx(
        sum(a.t_compute for a, _ in pairs), rel=1e-12)
    assert t.t_memory == sum(a.hbm_bytes_per_dev for a, _ in pairs) \
        / 3.35e12
    assert t.step_time_s == max(t.t_compute, t.t_memory)
    empty = rl.sum_terms("none", [])
    assert (empty.flops_per_dev, empty.step_time_s) == (0, 0.0)


@pytest.mark.parametrize("net", ["vgg16", "alexnet", "resnet18"])
def test_network_roofline_sums_the_steps(net):
    build = NetworkGraph.build if net == "resnet18" else NetworkPlan.build
    for kw in (dict(residency="never", fold_pooling=False), {}):
        plan = build(net, n=8, **kw)
        t = rl.network_roofline(net, plan)
        assert t.flops_per_dev == sum(
            s.plan.flops for s in plan.steps if s.plan is not None)
        assert t.hbm_bytes_per_dev == plan.hbm_bytes()["total"]
        assert t.t_compute == pytest.approx(sum(
            s.plan.flops / 67e12 for s in plan.steps
            if s.plan is not None), rel=1e-12)
        if kw:
            assert t.hbm_bytes_per_dev == sum(
                s.plan.hbm_bytes()["total"] for s in plan.steps
                if s.plan is not None) + sum(
                s.hbm_bytes()["total"] for s in plan.steps
                if s.plan is None)


def test_network_roofline_of_a_bf16_plan_prices_each_route():
    plan = NetworkPlan.build("vgg16", n=8, dtype_bytes=2)
    t = rl.network_roofline("vgg16-bf16", plan)
    want = sum(s.plan.flops / (989e12 if s.plan.bf16_route == "mma"
                               else 67e12) for s in plan.steps)
    assert t.t_compute == pytest.approx(want, rel=1e-12)
    assert plan.steps[0].plan.bf16_route == "ffma"      # Cin 3


def test_markdown_table():
    a = rl.RooflineTerms("a", 2e12, 6.7e9, 2**30, 1e12)
    b = rl.RooflineTerms("b", 1e9, 3.35e12, 0.0, 1e9, peak_flops=989e12)
    lines = rl.markdown_table([a, b]).split("\n")
    assert lines[0] == ("| cell | T_comp (ms) | T_mem (ms) | dominant | "
                        "model/executed | roofline frac | peak GiB/dev |")
    assert lines[1] == "|---|---|---|---|---|---|---|"
    assert lines[2] == ("| a | 29.85 | 2.00 | compute | 0.50 | "
                        "0.500 | 1.00 |")
    assert lines[3] == ("| b | 0.00 | 1000.00 | memory | 1.00 | "
                        "0.000 | 0.00 |")
    # JAX's table has the same columns but T_coll (its "useful/HLO"
    # named for XLA)
    j = jrl.markdown_table([]).split("\n")
    assert j[1] == lines[1] + "---|"
    assert j[0].replace("useful/HLO", "model/executed").replace(
        " T_coll (ms) |", "") == lines[0]
    row = a.as_row()
    assert row["peak_flops"] == 67e12 and row["peak_memory_gib"] == 1.0


ARCHS = treg.archs()


def test_the_registries_hold_the_same_archs():
    assert sorted(ARCHS) == sorted(jreg.archs())


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_active_params_equal_jax(arch):
    t, j = treg.get(arch).CONFIG, jreg.get(arch).CONFIG
    assert treg.count_active_params(t) == jreg.count_active_params(j)
    assert treg.count_params(t) == jreg.count_params(j)
    for kind, batch, seq in (("train", 256, 4096), ("prefill", 32, 32768),
                             ("decode", 128, 32768), ("prefill", 2, 4096),
                             ("train", 2, 1024)):
        assert treg.model_flops(t, kind, batch, seq) == jreg.model_flops(
            j, ShapePlan("cell", kind, batch=batch, seq=seq)), kind
    if t.family == "moe":
        assert treg.count_active_params(t) < treg.count_params(t)
    else:
        assert treg.count_active_params(t) == treg.count_params(t)
    with pytest.raises(ValueError, match="kind"):
        treg.model_flops(t, "serve", 1, 1)


def test_only_the_moe_leaves_carry_the_experts_mark():
    """The port's stand-in for JAX's ``"experts" in Param.axes``: the
    router and the experts' three weights of a MoE block, nothing
    else."""
    from repro_torch.models import api
    from repro_torch.models.base import Param

    def marked(tree, path=""):
        if isinstance(tree, Param):
            return [path] if tree.experts else []
        return [p for k, v in tree.items()
                for p in marked(v, f"{path}/{k}")]

    for arch in ARCHS:
        cfg = treg.get(arch).CONFIG
        got = marked(api.params(cfg))
        if cfg.family == "moe":
            assert sorted(got) == [f"/blocks/moe/{k}" for k in (
                "router", "w_down", "w_gate", "w_up")], arch
        else:
            assert got == [], arch
    assert dataclasses.replace(Param((2, 3)), experts=True).experts
