"""Roofline terms on the H100, and the one source of its peaks (the
counterpart of ``repro/core/roofline.py``).

Every peak and rate the port prices work with is defined here, for the
H100 SXM, and read from here by the plans (``core/conv_plan.py``) and by
``chip_smoke.py``:

    T_compute = FLOPs / the peak of the route that does them
    T_memory  = bytes / PEAK_BYTES_PER_S        (HBM3, 3.35 TB/s)

The TPU has one ``PEAK_FLOPS``; the card has one peak per route (FFMA,
the TF32, bf16 and int8 tensor cores, ``__dp4a``), so each
:class:`RooflineTerms` carries its own ``peak_flops``
(:func:`route_peak` picks it from a plan's element size and route).
``analyze_compiled`` and ``parse_collectives`` of the JAX module read an
XLA executable's cost analysis and HLO text, which a PyTorch program
does not have.  One card has no collective term: it comes with the
sharded conv plan (multi-GPU).
"""

from __future__ import annotations

from dataclasses import dataclass

# The H100 SXM's peaks (dense).
PEAK_F32_FLOPS = 67e12       # f32 outside the tensor cores (FFMA)
PEAK_TF32_FLOPS = 495e12     # TF32 tensor cores
PEAK_BF16_FLOPS = 989e12     # bf16 tensor cores
PEAK_INT8_OPS = 1979e12      # int8 tensor cores
# __dp4a on the integer pipes: 132 SMs x 64 lanes x 4 MACs x 2 ops x
# 1.98 GHz (the int8 kernel's dp4a route)
PEAK_DP4A_OPS = 132 * 64 * 4 * 2 * 1.98e9
PEAK_BYTES_PER_S = 3.35e12   # HBM3

# The element types the port runs: short names, then numpy / torch names
_DTYPE_BYTES = {"f32": 4, "bf16": 2, "s8": 1,
                "float32": 4, "bfloat16": 2, "int8": 1}


def dtype_width(dtype) -> int:
    """Byte width of ``dtype`` (f32, bf16 or int8): a short name
    (``"f32"``, ``"s8"``), a numpy or torch name (``"float32"``,
    ``"int8"``, ``"bfloat16"``), a ``torch.dtype`` or a numpy dtype."""
    if isinstance(dtype, str):
        name = dtype
    elif type(dtype).__module__ == "torch":          # torch.float32
        name = str(dtype).removeprefix("torch.")
    else:
        import numpy as np
        name = np.dtype(dtype).name
    try:
        return _DTYPE_BYTES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}") from None


def route_peak(dtype_bytes: int, route: str | None = None) -> float:
    """The peak rate of the units that do a kernel's arithmetic, by its
    element size and route:

    * f32 (4): FFMA, 67 TFLOP/s; route ``"tf32x3"`` (the flash kernel's
      narrow route: three TF32 products a product) 495 / 3;
    * bf16 (2): route ``"mma"`` the bf16 tensor cores, 989; any other
      route (``"ffma"``: the f32 fmaf chain on widened bf16) 67;
    * int8 (1): the int8 tensor cores, 1979 TOPS; route ``"dp4a"``
      ``__dp4a`` on the integer pipes.
    """
    if dtype_bytes == 4:
        return PEAK_TF32_FLOPS / 3 if route == "tf32x3" else PEAK_F32_FLOPS
    if dtype_bytes == 2:
        return PEAK_BF16_FLOPS if route == "mma" else PEAK_F32_FLOPS
    if dtype_bytes == 1:
        return PEAK_DP4A_OPS if route == "dp4a" else PEAK_INT8_OPS
    raise ValueError(f"no peak for {dtype_bytes}-byte elements")


def plan_peak(plan) -> float:
    """:func:`route_peak` of a ``ConvPlan``: bf16 plans by
    ``bf16_route``, int8 plans by ``route``."""
    if plan.dtype_bytes == 2:
        return route_peak(2, getattr(plan, "bf16_route", None))
    if plan.dtype_bytes == 1:
        return route_peak(1, plan.route)
    return route_peak(plan.dtype_bytes)


@dataclass
class RooflineTerms:
    """One cell's work and its two times.  ``peak_flops`` is the rate
    of the route that does the FLOPs (:func:`route_peak`)."""

    cell: str
    flops_per_dev: float
    hbm_bytes_per_dev: float
    peak_memory_bytes: float = 0.0
    model_flops_per_dev: float = 0.0
    peak_flops: float = PEAK_F32_FLOPS

    @property
    def t_compute(self) -> float:
        return self.flops_per_dev / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_dev / PEAK_BYTES_PER_S

    @property
    def dominant(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    @property
    def step_time_s(self) -> float:
        """Roofline step estimate: max of the two overlappable terms."""
        return max(self.t_compute, self.t_memory)

    @property
    def useful_flops_ratio(self) -> float:
        """Model FLOPs over executed FLOPs."""
        if self.flops_per_dev == 0:
            return 0.0
        return self.model_flops_per_dev / self.flops_per_dev

    @property
    def roofline_fraction(self) -> float:
        """Model FLOPs over what the route's peak does in the estimated
        step time."""
        if self.step_time_s == 0:
            return 0.0
        return self.model_flops_per_dev / (self.step_time_s
                                           * self.peak_flops)

    def as_row(self) -> dict:
        return {
            "cell": self.cell,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "flops_per_dev": self.flops_per_dev,
            "hbm_bytes_per_dev": self.hbm_bytes_per_dev,
            "peak_memory_gib": self.peak_memory_bytes / 2**30,
            "peak_flops": self.peak_flops,
        }


def sum_terms(cell: str, terms: list) -> RooflineTerms:
    """One sequential schedule of several kernels' terms: FLOPs, bytes
    and model FLOPs add, peak memory is the largest, and ``peak_flops``
    is the rate at which the summed FLOPs take the summed compute times
    (kernels on different routes keep their own times)."""
    flops = sum(t.flops_per_dev for t in terms)
    t_comp = sum(t.t_compute for t in terms)
    peak = flops / t_comp if t_comp else \
        next((t.peak_flops for t in terms), PEAK_F32_FLOPS)
    return RooflineTerms(
        cell=cell,
        flops_per_dev=flops,
        hbm_bytes_per_dev=sum(t.hbm_bytes_per_dev for t in terms),
        peak_memory_bytes=max((t.peak_memory_bytes for t in terms),
                              default=0.0),
        model_flops_per_dev=sum(t.model_flops_per_dev for t in terms),
        peak_flops=peak,
    )


def conv_plan_roofline(cell: str, plan, mode: str | None = None
                       ) -> RooflineTerms:
    """Terms of one conv layer read from its ``ConvPlan``: the bytes of
    ``plan.hbm_bytes(mode)`` (``None``: the plan's own schedule), its
    FLOPs at :func:`plan_peak`, a block's shared memory as the resident
    set."""
    traffic = plan.hbm_bytes(mode)
    return RooflineTerms(
        cell=cell,
        flops_per_dev=float(plan.flops),
        hbm_bytes_per_dev=float(traffic["total"]),
        peak_memory_bytes=float(plan.smem_bytes),
        model_flops_per_dev=float(plan.flops),
        peak_flops=plan_peak(plan),
    )


def network_roofline(cell: str, netplan) -> RooflineTerms:
    """Terms of a whole ``NetworkPlan`` or ``NetworkGraph``: the
    :func:`sum_terms` of its steps, each step's bytes under the network's
    residency decisions (resident boundaries move no device-memory
    bytes).  Join steps have no plan: their activation traffic is
    memory-only work with no FLOPs."""
    terms = []
    for s in netplan.steps:
        t = s.hbm_bytes()
        plan = getattr(s, "plan", None)
        flops = float(plan.flops) if plan is not None else 0.0
        terms.append(RooflineTerms(
            cell=s.name,
            flops_per_dev=flops,
            hbm_bytes_per_dev=float(t["total"]),
            peak_memory_bytes=float(plan.smem_bytes)
            if plan is not None else 0.0,
            model_flops_per_dev=flops,
            peak_flops=plan_peak(plan) if plan is not None
            else PEAK_F32_FLOPS,
        ))
    return sum_terms(cell, terms)


def markdown_table(rows: list[RooflineTerms]) -> str:
    """The terms as a markdown table (JAX's columns but its T_coll;
    "model/executed" is JAX's "useful/HLO": model FLOPs over the FLOPs
    the kernels run)."""
    hdr = ("| cell | T_comp (ms) | T_mem (ms) | dominant | "
           "model/executed | roofline frac | peak GiB/dev |\n"
           "|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in rows:
        lines.append(
            f"| {r.cell} | {r.t_compute*1e3:.2f} | {r.t_memory*1e3:.2f} "
            f"| {r.dominant} "
            f"| {r.useful_flops_ratio:.2f} | {r.roofline_fraction:.3f} "
            f"| {r.peak_memory_bytes/2**30:.2f} |")
    return "\n".join(lines)
