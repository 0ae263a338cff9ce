"""Energy / area model reproducing Table I of the paper (the counterpart
of ``repro/core/energy.py``).

The paper normalizes competing ASICs to 22 nm with DeepScaleTool [19, 20].
We recover the effective DeepScaleTool scaling factors from the paper's own
raw/normalized pairs (they are consistent across rows) and encode them, so
``table1()`` reproduces the published table and can score new design points.

A small Horowitz-style energy model (`energy_per_inference`) converts the
access counts of `core.model` into energy, quantifying the architectural
claim that one external access costs 2-3 orders of magnitude more than a
MAC [3].
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core import model as acc_model

# DeepScaleTool factors to 22 nm, recovered from Table I raw/normalized
# pairs ([18]/[11]: 7 nm, [12]: 65 nm).  freq_scale multiplies throughput,
# area/power scale multiply their raw values.
_SCALE_TO_22NM = {
    7:  dict(freq=0.852, area=19.98, power=2.283),
    22: dict(freq=1.0, area=1.0, power=1.0),
    65: dict(freq=1.571, area=0.108, power=0.458),
}


@dataclass(frozen=True)
class ASICDesign:
    name: str
    pes: int
    tech_nm: int
    freq_ghz: float
    peak_tops: float
    area_mm2: float
    power_w: float

    def normalized(self) -> dict:
        s = _SCALE_TO_22NM[self.tech_nm]
        tops = self.peak_tops * s["freq"]
        area = self.area_mm2 * s["area"]
        power = self.power_w * s["power"]
        return {
            "name": self.name,
            "pes": self.pes,
            "tech_nm": self.tech_nm,
            "freq_ghz": self.freq_ghz,
            "peak_tops": self.peak_tops,
            "norm_tops": tops,
            "norm_area_mm2": area,
            "norm_power_w": power,
            "norm_energy_eff_tops_per_w": tops / power,
            "norm_area_eff_tops_per_mm2": tops / area,
        }


TABLE1_DESIGNS = [
    ASICDesign("tpu-v4i [18]", 65536, 7, 1.05, 138.0, 400.0, 175.0),
    ASICDesign("eyeriss [12]", 168, 65, 0.2, 0.07, 12.25, 0.24),
    ASICDesign("multi-precision SA [11]", 256, 7, 2.0, 1.02, 3.81, 5.12),
    ASICDesign("3d-trim (this work)", 576, 22, 1.0, 1.15, 0.26, 0.25),
]


def table1() -> list[dict]:
    return [d.normalized() for d in TABLE1_DESIGNS]


def peak_tops(pes: int, freq_ghz: float) -> float:
    """Peak throughput: every PE performs one MAC (= 2 OPs) per cycle."""
    return pes * 2 * freq_ghz / 1e3


# ---------------------------------------------------------------------------
# Horowitz-style energy accounting [3] (45 nm reference points, pJ)
# ---------------------------------------------------------------------------

ENERGY_PJ = {
    "dram_access": 640.0,     # external memory, per 32-bit word
    "sram_access": 5.0,       # large on-chip buffer
    "register": 0.06,         # local register move (shift / shadow)
    "mac_int8": 0.23,         # 8-bit multiply-accumulate
    "mac_fp32": 4.6,          # fp32 mult (3.7) + add (0.9)
}


def energy_per_layer(layer: acc_model.ConvLayer,
                     hw: acc_model.HWConfig, *,
                     dtype_bytes: int = 1,
                     mac: str = "mac_int8") -> dict:
    """Energy (uJ) split between external accesses and compute.

    ``core.model.layer_accesses`` counts *element* accesses; the DRAM
    reference energy is per 32-bit word, so a transfer is billed at
    ``dtype_bytes / 4`` of it — an int8 element (the paper's silicon,
    the default) moves a quarter of the bytes an f32 element does.
    ``mac`` picks the MAC energy (``"mac_int8"`` / ``"mac_fp32"``),
    which together with ``dtype_bytes`` prices a whole network in either
    precision.
    """
    acc = acc_model.layer_accesses(layer, hw)
    e_mem = acc.total * ENERGY_PJ["dram_access"] * (dtype_bytes / 4.0)
    e_mac = layer.macs * ENERGY_PJ[mac]
    # every MAC implies ~3 register moves (activation shift, psum, product)
    e_reg = layer.macs * 3 * ENERGY_PJ["register"]
    return {
        "layer": layer.label(),
        "hw": hw.name,
        "memory_uJ": e_mem / 1e6,
        "compute_uJ": (e_mac + e_reg) / 1e6,
        "total_uJ": (e_mem + e_mac + e_reg) / 1e6,
        "memory_fraction": e_mem / (e_mem + e_mac + e_reg),
    }


_NETWORK_LAYER_FNS = {
    "vgg16": acc_model.vgg16_layers,
    "alexnet": acc_model.alexnet_layers,
    "mobilenet": acc_model.mobilenet_layers,
}


def energy_per_inference(network: str = "vgg16",
                         hw: acc_model.HWConfig = acc_model.TRIM_3D, *,
                         dtype_bytes: int = 1,
                         mac: str = "mac_int8") -> dict:
    """Modeled energy for one inference of a whole network.

    ``tops_per_watt`` is the modeled efficiency of the access pattern:
    total OPs (2 per MAC) divided by total modeled energy — 1 OP/pJ is
    exactly 1 TOPS/W, so the figure is directly comparable to the
    paper's Table I silicon numbers.
    """
    try:
        layers = _NETWORK_LAYER_FNS[network]()
    except KeyError:
        # DAG topologies: the access-count model is per conv layer, so
        # a graph's energy is the sum over its conv nodes (joins move
        # activations but drive no MAC/register energy terms here)
        from repro_torch.core.netplan import GRAPHS, graph_nodes
        if network not in GRAPHS:
            raise ValueError(
                f"unknown network {network!r}; choose from "
                f"{sorted(_NETWORK_LAYER_FNS) + sorted(GRAPHS)}") \
                from None
        layers = [nd.layer for nd in graph_nodes(network)
                  if nd.op == "conv"]
    per = [energy_per_layer(l, hw, dtype_bytes=dtype_bytes, mac=mac)
           for l in layers]
    total_uJ = sum(p["total_uJ"] for p in per)
    ops = 2 * sum(l.macs for l in layers)
    return {
        "network": network,
        "hw": hw.name,
        "dtype_bytes": dtype_bytes,
        "mac": mac,
        "total_uJ": total_uJ,
        "memory_uJ": sum(p["memory_uJ"] for p in per),
        "tops_per_watt": ops / (total_uJ * 1e6),   # OPs / pJ == TOPS/W
        "layers": per,
    }
