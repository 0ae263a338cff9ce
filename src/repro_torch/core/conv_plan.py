"""Hopper launch geometry for one 3D-TrIM convolution and its gradients.

:class:`ConvPlan` is the counterpart of ``repro.core.conv_plan.ConvPlan``
for the H100 forward kernel of ``kernels/csrc/trim_conv2d.cu`` (which
also runs the input gradient, laid out by :func:`input_grad_geometry`);
:class:`WeightGradPlan` plans the weight-gradient kernel of
``kernels/csrc/trim_conv2d_wgrad.cu`` (:class:`BF16WeightGradPlan` its
bf16 entry, on the bf16 tensor cores where :func:`wgrad_route` says
``"mma"``; constants ``WGRAD_*``, route mma's ``WGRAD_MMA_*``),
:class:`Conv1dPlan` the causal
depthwise conv1d of ``kernels/csrc/trim_conv1d.cu`` (also its input
gradient) and :class:`Conv1dWeightGradPlan` its weight gradient,
``kernels/csrc/trim_conv1d_wgrad.cu``.  The TPU forward plan
sizes its strips for an 8 MiB VMEM budget and 128-lane C_out tiles;
neither applies to the card, where a block has at most 227 KB of shared
memory.  So a block here owns a *column band* of ``tile_w`` output
columns as well as a C_out tile, and holds the band's input window for
all ``Cin/groups`` channels:

* ``tile_h`` — fresh input rows per strip (a multiple of the stride; the
  strip makes ``tile_h // stride`` output rows).  Oversized strips are
  clamped to the full height, as ``ConvPlan`` clamps them
  (``repro/core/conv_plan.py:166-173``).
* ``carry_rows = max(KH - stride, 0)`` — the rows a strip shares with its
  successor: kept in shared memory by ``carry``, re-read by ``halo``.
* ``segments`` — a band's strips are cut into this many carry chains,
  one block each; each loads its first window whole and then carries.
  ``halo`` is the limit of one strip a segment.
* ``ring_rows x window_cols x cin_stride`` — the shared-memory ring of
  input rows; ``smem_bytes`` adds the weight ring and must fit
  :data:`SMEM_PER_BLOCK`.

``dtype_bytes`` picks the kernel: 4 is the f32 kernel, 2 its bf16
entries (:class:`BF16ConvPlan`: bf16 operands, window, weight ring and
output; route ``"mma"`` where Cin/g is a multiple of 16, the bf16 tensor
cores in the k-order of ``kernels/csrc/bf16_mma.cuh``, planned like the
int8 mma route by :func:`_build_bf16_mma`; route ``"ffma"`` elsewhere,
the same f32 ``fmaf`` chain; :func:`bf16_route`; 16-byte copies carry 8
channels, so the padded pitch is ``Cin/g + 8``), 1 the int8 kernel of
``kernels/csrc/trim_conv2d_q8.cu``
(int8 operands, f32 output), whose window is held in bytes.  The int8
kernel has three routes (:attr:`ConvPlan.route`): ``"mma"`` (Cin/g a
multiple of 16) and ``"im2col"`` (small Cin, groups == 1) run
``mma.sync`` m16n8k32 on the int8 tensor cores with 8 warps of
``warps_m x warps_n x warps_k``, each holding ``m_frags`` m16 x 4 n8
fragments, the M tile sized per call by a clock model
(:func:`_q8_strip_clocks`); ``"dp4a"`` (depthwise and other grouped convs
with Cin/g < 16) keeps the f32 kernel's threads and tiles.

Kernels are ``KH x KW``, as in the JAX ``ConvPlan``: the f32 plans take
the rectangular sub-kernels of the kernel tiling (``core/tiling.py``: an
11 x 11 kernel runs as 3 x 3, 3 x 2, 2 x 3 and 2 x 2 pieces); the int8
plan stays square.

The forward kernel's constants are the ``CONV_*`` values below; they
mirror the ``constexpr`` values at the top of ``trim_conv2d.cu``; its bf16
mma route's are ``BF16_MMA_*`` (``trim_conv2d.cu`` and ``bf16_mma.cuh``);
the int8 kernel's own are ``Q8_*``.  The fused kernel's are ``FUSED_*`` in
``core/fuse_plan.py``.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import ClassVar

from repro_torch.core.roofline import (PEAK_BF16_FLOPS, PEAK_BYTES_PER_S,
                                       PEAK_F32_FLOPS)

SMEM_PER_BLOCK = 232_448     # H100: 227 KB of opt-in shared memory per block
SMEM_PER_SM = 233_472        # H100: 228 KB of shared memory per SM
SMEM_RESERVED_PER_BLOCK = 1_024   # taken by the runtime from each block
SMS = 132                    # H100 SXM streaming multiprocessors
WARP = 32
# The forward kernel (trim_conv2d.cu)
CONV_THREADS = 256           # threads per block (kThreads)
CONV_POSITIONS = 8           # output positions a thread (kPositions)
CONV_COUT = 4                # output channels a thread, one float4 (kCout)
CONV_MAX_TILE_COUT = WARP * CONV_COUT    # a warp along C_out: 128
CONV_WEIGHT_CHUNK = 16       # input channels of one tap a weight stage
CONV_WEIGHT_STAGES = 2       # the weight ring's stages (kStages)
CONV_BLOCKS_PER_SM = 2       # __launch_bounds__(kThreads, 2): <= 128 regs
CONV_MAX_TILE_W = 64         # widest band the planner tries
# The int8 forward kernel (trim_conv2d_q8.cu), one byte an operand element;
# CONV_THREADS and CONV_BLOCKS_PER_SM as above.  Tensor-core routes:
Q8_WARPS = CONV_THREADS // WARP   # warps a block (kWarps)
Q8_MMA_M = 16                # positions of one m16n8k32 fragment (kMmaM)
Q8_MMA_N = 8                 # output channels of one fragment (kMmaN)
Q8_MMA_K = 32                # bytes of k of one k-step (kMmaK)
Q8_WARP_N = 32               # output channels a warp: 4 n8 fragments (kWarpN)
Q8_MAX_M_FRAGS = 4           # m16 fragments a warp at most (kMaxMFrags),
Q8_M_FRAGS_TWO = 2           # ... two blocks an SM (kMaxMFragsTwo: <= 128
                             # registers; more take an SM alone)
Q8_STAGE_STEPS = 4           # k-steps of one weight stage (kStageSteps)
Q8_STAGES = 3                # the weight ring's stages (kStages)
Q8_ROW_PAD = 16              # bytes past each weight-stage and im2col row
Q8_STAGING = 16 * (Q8_WARP_N + 4) * 4   # a warp's epilogue staging bytes
Q8_IM2COL_MAX_K = 256        # longest padded (ki, kj, ci) row of im2col
# ... and the dp4a route (the __dp4a loop: CONV_POSITIONS x CONV_COUT a
# thread)
Q8_QUAD = 4                  # input channels of one __dp4a word (kQuad)
Q8_VEC = 16                  # input channels of one 16-byte window load (kVec)
Q8_WEIGHT_CHUNK = 64         # input channels of one tap a weight stage
Q8_WEIGHT_STAGES = 2         # the dp4a weight ring's stages (kDp4aStages)
Q8_ROUTES = ("mma", "im2col", "dp4a")
# The int8 plan's clock model (a ranking of tiles): the kernel is bound by
# latency, not by the tensor cores (mma.sync s8 runs 1,230-1,280 TOPS from
# registers on the H100, tools/q8_ablation.py), so a warp's k-step takes
# about Q8_KSTEP_CLOCKS whatever its tile, the blocks resident on an SM
# overlap, and one m16 fragment's epilogue adds Q8_EPILOGUE_CLOCKS
# (clock64 probes and forced tiles on the card, PERF.md section 6)
Q8_KSTEP_CLOCKS = 900.0
Q8_EPILOGUE_CLOCKS = 2000.0
Q8_TILE_COUTS = (128, 64, 32)   # C_out tiles the int8 plan tries
# The bf16 instance of the forward kernel (trim_conv2d.cu) has two routes
# (bf16_route): "mma" on the bf16 tensor cores, whose k-order is
# csrc/bf16_mma.cuh's (its kBf16* constants), and "ffma", the f32 kernel's
# fmaf chain on bf16.  Route mma (kWarps, kMma* of trim_conv2d.cu):
BF16_ROUTES = ("ffma", "mma")   # the bf16 entries' route codes, in order
BF16_MMA_M = 16              # positions of one m16n8k16 fragment (kBf16MmaM)
BF16_MMA_N = 8               # output channels of one fragment (kBf16MmaN)
BF16_MMA_K = 16              # input channels of one k-step (kBf16MmaK)
BF16_MMA_WARP_N = 32         # output channels a warp: 4 n8 fragments
BF16_MMA_ROW_PAD = 8         # bf16 past each weight-stage row (kBf16RowPad)
BF16_MMA_WARPS = CONV_THREADS // WARP   # warps a block (kWarps)
BF16_MMA_MAX_M_FRAGS = 4     # m16 fragments a warp at most (kMmaMaxMFrags),
BF16_MMA_M_FRAGS_TWO = 2     # ... two blocks an SM (kMmaMFragsTwo)
BF16_MMA_STAGE_STEPS = 4     # k-steps of one weight stage (kMmaStageSteps)
BF16_MMA_STAGES = 3          # the weight ring's stages (kMmaStages)
BF16_MMA_STAGING_PITCH = BF16_MMA_WARP_N + 8   # bf16 a staging row
# its plan's clock model, a ranking of tiles like the int8 one's: one
# k-step of a warp, plus the block's weight copies it waits on (per warp
# along C_out: 32 channels of the stage), and one m16 fragment's epilogue.
# The copy term is fitted to the tuner's candidate tiles of VGG-16's and
# AlexNet's mma layers at N 1-8 timed on the card
# (tools/bf16_tile_sweep.py: a flat optimum from 225 to 450)
BF16_MMA_KSTEP_CLOCKS = 900.0
BF16_MMA_COPY_CLOCKS = 300.0
BF16_MMA_EPILOGUE_CLOCKS = 2000.0
BF16_TILE_COUTS = (128, 64, 32)   # C_out tiles the mma plan tries
DATAFLOWS = ("carry", "halo")
DTYPE_BYTES = {4: "float32", 2: "bfloat16", 1: "int8"}


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA 'SAME' padding: out = ceil(size/s), possibly asymmetric."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def normalize_pad(pad) -> tuple[tuple[int, int], tuple[int, int]]:
    """``pad`` as ``((top, bottom), (left, right))``: an int is symmetric
    zero padding on all four sides (the JAX ``trim_conv2d`` argument)."""
    if isinstance(pad, int):
        return (pad, pad), (pad, pad)
    (pt, pb), (pl, pr) = pad
    pads = ((int(pt), int(pb)), (int(pl), int(pr)))
    if min(pads[0] + pads[1]) < 0:
        raise ValueError(f"negative padding {pad!r}")
    return pads


def _smem_bytes(window_elems: int, threads_cout: int,
                dtype_bytes: int) -> int:
    """Shared memory of one block of the forward kernel (f32 or bf16) or
    the int8 kernel: a window of ``window_elems`` elements rounded up to
    16 bytes, and the weight ring (stages x chunk input channels x 4
    channels a thread along C_out)."""
    window = -(-window_elems * dtype_bytes // 16) * 16
    if dtype_bytes != 1:
        chunk, stages = CONV_WEIGHT_CHUNK, CONV_WEIGHT_STAGES
    else:
        chunk, stages = Q8_WEIGHT_CHUNK, Q8_WEIGHT_STAGES
    return window + dtype_bytes * stages * chunk * CONV_COUT * threads_cout


def _channel_pitches(cin_per_group: int, dtype_bytes: int = 4) -> list:
    """Window channel pitches to try, best first.  f32: ``Cin/g + 4``
    (bank-conflict free) where Cin/g is a multiple of 4, then ``Cin/g``.
    bf16: ``Cin/g + 8`` where Cin/g is a multiple of 8 (16 bytes: the
    window's 16-byte copies stay aligned and the positions a warp reads
    fall on different banks), then ``Cin/g``.  int8 (the dp4a route):
    Cin/g rounded up to a :data:`Q8_QUAD` (four channels a ``__dp4a``
    word, the extra ones zero)."""
    c = cin_per_group
    if dtype_bytes == 4:
        return [c + 4, c] if c % 4 == 0 else [c]
    if dtype_bytes == 2:
        return [c + 8, c] if c % 8 == 0 else [c]
    return [q8_cin4(cin_per_group)]


def q8_cin4(cin_per_group: int) -> int:
    """Cin/g rounded up to a :data:`Q8_QUAD`: the channels of one tap in
    the int8 kernel's packed weight row (the extra ones zero)."""
    return -(-cin_per_group // Q8_QUAD) * Q8_QUAD


def q8_tap_bytes(cin_per_group: int) -> int:
    """Bytes of one tap in the int8 kernel's packed weight row: Cin/g
    rounded up to a 32-byte k-step where it is a multiple of 16 (the mma
    route: a 16-channel tail zero-padded, so a k-step never spans two
    taps), else :func:`q8_cin4`."""
    if cin_per_group % Q8_VEC == 0:
        return -(-cin_per_group // Q8_MMA_K) * Q8_MMA_K
    return q8_cin4(cin_per_group)


def q8_kpad(k: int, cin_per_group: int) -> int:
    """Bytes of one output channel's packed int8 weight row: the
    ``(ki, kj, ci)`` axis, ``K * K`` taps of :func:`q8_tap_bytes`, rounded
    up to a k-step (:data:`Q8_MMA_K`)."""
    return -(-k * k * q8_tap_bytes(cin_per_group) // Q8_MMA_K) * Q8_MMA_K


def q8_route(cin_per_group: int, groups: int, k: int) -> str:
    """The int8 kernel's route for a shape: ``"mma"`` (the tensor cores
    straight from the window) where Cin/g is a multiple of 16,
    ``"im2col"`` (an im2col tile, then the same MMA loop) for groups == 1
    and a packed row of at most :data:`Q8_IM2COL_MAX_K` bytes, else
    ``"dp4a"`` (one output channel a depthwise A tile leaves the tensor
    cores nothing to fill)."""
    if cin_per_group % Q8_VEC == 0:
        return "mma"
    if groups == 1 and q8_kpad(k, cin_per_group) <= Q8_IM2COL_MAX_K:
        return "im2col"
    return "dp4a"


def bf16_route(cin_per_group: int, groups: int = 1) -> str:
    """The bf16 route of a conv layer, a function of its geometry alone:
    ``"mma"`` (the bf16 tensor cores, the k-order of ``csrc/bf16_mma.cuh``)
    where Cin/g is a multiple of :data:`BF16_MMA_K` (every k-step a run of
    16 channels of one tap), else ``"ffma"`` (the f32 kernel's fmaf chain
    on bf16: the Cin-3 first layers, depthwise and other narrow groups).
    ``ConvPlan.build(dtype_bytes=2)``, the input gradient's plan, the
    fused plan and the tuner all take the route from here; ``groups``
    only names the layer (the route reads Cin/g)."""
    del groups
    return "mma" if cin_per_group % BF16_MMA_K == 0 else "ffma"


def _q8_mma_pitches(cin_per_group: int) -> list:
    """The mma route's window pitches, best first: ``Cin/g`` or ``Cin/g
    + 16``, whichever is an odd count of 16-byte quads, so that the 8
    neighbouring positions an ``ldmatrix`` phase reads (one pitch apart
    on the phase-split window) hit 8 distinct bank quads; then
    ``Cin/g``."""
    c = cin_per_group
    odd = c if (c // Q8_VEC) % 2 else c + Q8_VEC
    return [odd] if odd == c else [odd, c]


def _blocks_per_sm(smem: int) -> int:
    """Resident blocks of the forward kernel on one SM: its register cap
    (:data:`CONV_BLOCKS_PER_SM`) or its shared memory, the fewer."""
    return min(CONV_BLOCKS_PER_SM,
               SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK))


def slice_reads_per_channel(height: int, width: int, kernel: int,
                            stride: int = 1, *, shadow: bool) -> int:
    """External reads of one ifmap channel for one pass of a TrIM slice
    (the paper's Fig. 1; ``repro/core/conv_plan.py:98``).

    The sliding-window band advances by ``stride`` rows per output row.
    With shadow registers (3D-TrIM) every real activation is read exactly
    once.  Without them (TrIM), every band advance re-reads the last
    ``K-1`` activations of each of the ``K - stride`` re-used rows.
    """
    ideal = height * width
    if shadow:
        return ideal
    out_rows = (height - kernel) // stride + 1
    band_advances = max(out_rows - 1, 0)
    reused_rows = max(kernel - stride, 0)
    rereads_per_advance = reused_rows * (kernel - 1)
    return ideal + band_advances * rereads_per_advance


@dataclass(frozen=True)
class ConvPlan:
    """Launch geometry of one strided, grouped NHWC conv on the card.

    Input ``(N, H, W, Cin)``, weights ``(KH, KW, Cin/groups, Cout)``, zero
    padding ``pads = ((top, bottom), (left, right))`` applied virtually by
    the kernel's loader.

    Threads: ``threads_cout`` threads along C_out, each with
    :data:`CONV_COUT` channels (one float4 of weights a step), and
    ``CONV_THREADS // threads_cout`` along positions, each with
    :data:`CONV_POSITIONS`: a strip of one band is at most ``slots``
    output positions, all computed in one pass.  ``cin_stride`` is the
    window's channel pitch in elements (:func:`_channel_pitches`): for f32
    ``Cin/groups``, plus 4 where it is a multiple of 4 and the padded
    window fits, so that the two to four positions a warp reads at once
    fall on different banks.

    int8 (``dtype_bytes=1``): ``route`` names the kernel's route.  On the
    tensor-core routes the 8 warps are ``warps_m x warps_n x warps_k``
    (along positions, C_out and the ``(ki, kj, ci)`` axis), each with
    ``m_frags`` m16 fragments of positions x 4 n8 fragments of C_out, so
    a strip is at most ``slots = 16 m_frags warps_m`` positions and a C_out
    tile at most ``32 warps_n`` channels; the window's columns are stored
    phase-split by the stride (:attr:`col_slots`) and ``cin_stride`` is an
    odd count of 16-byte quads where it fits (:func:`_q8_mma_pitches`).
    The dp4a route keeps the f32 kernel's threads (the warp fields 0).
    """

    n: int
    h: int
    w: int
    cin: int
    cout: int
    kh: int
    kw: int
    stride: int
    pads: tuple
    groups: int
    tile_h: int
    tile_w: int
    tile_cout: int
    dataflow: str = "carry"
    cin_stride: int = 0          # 0: Cin/groups
    dtype_bytes: int = 4         # 4: the f32 kernel; 1: the int8 kernel
    warps_n: int = 0             # int8 tensor-core routes: warps along C_out
    warps_k: int = 0             # ... along the (ki, kj, ci) axis
    m_frags: int = 0             # ... m16 fragments of positions a warp

    def __post_init__(self):
        if self.dtype_bytes not in DTYPE_BYTES:
            raise ValueError(f"dtype_bytes={self.dtype_bytes} must be one "
                             f"of {sorted(DTYPE_BYTES)} (int8, bf16, f32)")
        if self.dataflow not in DATAFLOWS:
            raise ValueError(f"dataflow={self.dataflow!r} must be one of "
                             f"{DATAFLOWS}")
        if self.tile_h < self.stride or self.tile_h % self.stride:
            raise ValueError(f"tile_h={self.tile_h} must be a positive "
                             f"multiple of the stride {self.stride}")
        if self.dtype_bytes == 1 and self.kh != self.kw:
            raise ValueError(f"the int8 kernel takes square kernels, got "
                             f"{self.kh}x{self.kw}")
        if not 1 <= self.tile_cout <= CONV_MAX_TILE_COUT:
            raise ValueError(f"tile_cout={self.tile_cout} must be in [1, "
                             f"{CONV_MAX_TILE_COUT}]")
        if self.cin_stride == 0:
            object.__setattr__(self, "cin_stride", self.cin_per_group)
        if self.cin_stride < self.cin_per_group:
            raise ValueError(f"cin_stride={self.cin_stride} < Cin/groups")
        if self.tensor_cores and not (
                self.warps_n in (1, 2, 4) and self.warps_k in (1, 2, 4)
                and self.warps_n * self.warps_k <= Q8_WARPS
                and 1 <= self.m_frags <= Q8_MAX_M_FRAGS
                and (self.warps_k == 1 or self.m_frags == 1)
                and self.tile_cout <= Q8_WARP_N * self.warps_n):
            raise ValueError(
                f"the int8 {self.route} route takes warps_n and warps_k in "
                f"(1, 2, 4), at most {Q8_WARPS} warps, 1..{Q8_MAX_M_FRAGS} "
                f"m16 fragments (1 where warps_k > 1) and tile_cout <= "
                f"{Q8_WARP_N} x warps_n; got warps_n={self.warps_n}, "
                f"warps_k={self.warps_k}, m_frags={self.m_frags}, "
                f"tile_cout={self.tile_cout}")

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, x_shape, w_shape, *, stride: int = 1, pad=0,
              groups: int = 1, tile_h: int | None = None,
              tile_cout: int | None = None, dataflow: str = "carry",
              dtype_bytes: int = 4) -> "ConvPlan":
        """Plan from tensor shapes, choosing any tile left as ``None``.

        ``tile_cout`` left as ``None`` is the per-group C_out up to
        :data:`CONV_MAX_TILE_COUT` (a warp of threads, four channels
        each) or up to half that (twice the positions), whichever plans
        better below.  The band and strip (``tile_w`` x ``tile_h / stride``
        output positions, at most ``slots``) are the pair whose window
        fits :data:`SMEM_PER_BLOCK` and whose busiest SM walks the fewest
        strips (each a full pass of the slots, so ragged edges, idle
        slots and SMs left without a block all count), then the one
        reading the fewest window pixels per output; a given ``tile_h``
        fixes the strip.  ``dtype_bytes=2`` plans the bf16 instance of the
        forward kernel, ``dtype_bytes=1`` the int8 kernel.  Raises
        ``ValueError`` when no geometry fits, so every plan it returns is
        one the kernel takes.  Plans are cached by argument.
        """
        return _build(tuple(int(v) for v in x_shape),
                      tuple(int(v) for v in w_shape), stride,
                      normalize_pad(pad), groups, tile_h, tile_cout, dataflow,
                      dtype_bytes)

    # -- problem geometry --------------------------------------------------

    @property
    def cin_per_group(self) -> int:
        return self.cin // self.groups

    @property
    def cout_per_group(self) -> int:
        return self.cout // self.groups

    @property
    def h_out(self) -> int:
        return (self.h + sum(self.pads[0]) - self.kh) // self.stride + 1

    @property
    def w_out(self) -> int:
        return (self.w + sum(self.pads[1]) - self.kw) // self.stride + 1

    @property
    def out_shape(self) -> tuple[int, int, int, int]:
        return (self.n, self.h_out, self.w_out, self.cout)

    # -- strip / band geometry ---------------------------------------------

    @property
    def th_out(self) -> int:
        """Output rows per strip."""
        return self.tile_h // self.stride

    @property
    def carry_rows(self) -> int:
        """Rows a strip shares with its successor (carried or re-read)."""
        return max(self.kh - self.stride, 0)

    @property
    def window_rows(self) -> int:
        return self.tile_h + self.carry_rows

    @property
    def window_cols(self) -> int:
        return (self.tile_w - 1) * self.stride + self.kw

    @property
    def n_strips(self) -> int:
        return -(-self.h_out // self.th_out)

    @property
    def n_bands(self) -> int:
        return -(-self.w_out // self.tile_w)

    @property
    def co_tiles(self) -> int:
        return -(-self.cout_per_group // self.tile_cout)

    @property
    def chains(self) -> int:
        """(image, group, C_out tile, band) tuples: one column of strips
        each."""
        return self.n * self.groups * self.co_tiles * self.n_bands

    # -- the int8 kernel's route -------------------------------------------

    @property
    def route(self) -> str:
        """``"f32"``, ``"bf16"``, or the int8 kernel's route
        (:func:`q8_route`)."""
        if self.dtype_bytes == 4:
            return "f32"
        if self.dtype_bytes == 2:
            return "bf16"
        return q8_route(self.cin_per_group, self.groups, self.kh)

    @property
    def tensor_cores(self) -> bool:
        return self.route in ("mma", "im2col")

    @property
    def cin4(self) -> int:
        return q8_cin4(self.cin_per_group)

    @property
    def kpad(self) -> int:
        """Bytes of one output channel's packed int8 weight row."""
        return q8_kpad(self.kh, self.cin_per_group)

    @property
    def k_steps(self) -> int:
        """Tensor-core routes: k-steps of 32 bytes a strip, the packed
        row's (mma: each tap's Cin/g in steps of 32; im2col: the im2col
        row's)."""
        return self.kpad // Q8_MMA_K

    @property
    def weight_stages(self) -> int:
        """Tensor-core routes: weight-ring stages a strip."""
        return -(-self.k_steps // Q8_STAGE_STEPS)

    @property
    def warps_m(self) -> int:
        """Tensor-core routes: warps along positions (0 otherwise)."""
        if not self.tensor_cores:
            return 0
        return Q8_WARPS // (self.warps_n * self.warps_k)

    @property
    def col_slots(self) -> int:
        """Window columns a ring row holds.  Tensor-core routes: phase
        split, column ``c`` at ``(c % s) * ceil(cols / s) + c // s``, so
        positions one output column apart are one pitch apart at every
        tap; otherwise the window's columns in order."""
        if not self.tensor_cores:
            return self.window_cols
        return self.stride * -(-self.window_cols // self.stride)

    @property
    def row_bytes(self) -> int:
        """Bytes of one window ring row.  mma: the columns plus the fewest
        16-byte quads that make the next output row (``stride`` ring rows
        on) continue this one's bank-quad sequence, so an ``ldmatrix``
        phase that crosses output rows stays conflict free (none where
        the stride and band make that impossible)."""
        cols = self.col_slots * self.cin_stride
        if self.route != "mma":
            return cols
        quads = self.cin_stride // 16
        return cols + 16 * next(
            (d for d in range(8)
             if (self.stride * (cols // 16 + d) - self.tile_w * quads) % 8
             == 0), 0)

    # -- thread layout -----------------------------------------------------

    @property
    def threads_cout(self) -> int:
        """Threads along C_out, :data:`CONV_COUT` channels each."""
        return -(-self.tile_cout // CONV_COUT)

    @property
    def slots(self) -> int:
        """Output positions the block holds in registers: the warps' m16
        fragments on the int8 tensor-core routes."""
        if self.tensor_cores:
            return Q8_MMA_M * self.m_frags * self.warps_m
        return CONV_THREADS // self.threads_cout * CONV_POSITIONS

    @property
    def positions(self) -> int:
        """Output positions of one strip of one band."""
        return self.th_out * self.tile_w

    # -- segments and shared memory ------------------------------------------

    def _smem(self, ring_rows: int) -> int:
        if self.tensor_cores:
            # window ring, weight ring, epilogue staging, im2col tile
            window = -(-ring_rows * self.row_bytes // 16) * 16
            stages = (Q8_STAGES * Q8_WARP_N * self.warps_n
                      * (Q8_STAGE_STEPS * Q8_MMA_K + Q8_ROW_PAD))
            im2col = (self.slots * (self.kpad + Q8_ROW_PAD)
                      if self.route == "im2col" else 0)
            return window + stages + Q8_WARPS * Q8_STAGING + im2col
        return _smem_bytes(ring_rows * self.window_cols * self.cin_stride,
                           self.threads_cout, self.dtype_bytes)

    @property
    def segments(self) -> int:
        """Carry chains a band's strips are cut into, one block each.
        ``halo``: one a strip.  ``carry``: of the counts that give at
        least one full wave of resident blocks over the 132 SMs, the
        fewest whose busiest SM walks at most 10% more strips than under
        the best count (the fewest alone can leave some SMs a whole chain
        of strips more than the rest).  The int8 tensor-core routes count
        whole rounds of resident blocks instead (:attr:`rounds`): the
        fewest rounds x strips a segment, then the fewest segments."""
        if self.dataflow == "halo":
            return self.n_strips
        wave = SMS * self._resident(self._smem(self.window_rows))
        counts = sorted({-(-self.n_strips // -(-self.n_strips // s))
                         for s in range(1, self.n_strips + 1)})
        if self.tensor_cores:
            return min(counts, key=lambda c: (
                -(-self.chains * c // wave) * -(-self.n_strips // c), c))
        full = [c for c in counts if self.chains * c >= wave] or counts[-1:]
        cost = {c: -(-self.chains * c // SMS) * -(-self.n_strips // c)
                for c in full}
        best = min(cost.values())
        return next(c for c in full if cost[c] <= 1.1 * best)

    @property
    def strips_per_segment(self) -> int:
        return -(-self.n_strips // self.segments)

    def _resident(self, smem: int) -> int:
        """Blocks resident on one SM at ``smem`` bytes a block: the
        register cap (one where the int8 kernel holds more than
        :data:`Q8_M_FRAGS_TWO` m16 fragments a warp) or shared memory."""
        if self.tensor_cores and self.m_frags > Q8_M_FRAGS_TWO:
            return min(1, _blocks_per_sm(smem))
        return _blocks_per_sm(smem)

    @property
    def blocks_per_sm(self) -> int:
        """Blocks resident on one SM (registers or shared memory)."""
        return self._resident(self.smem_bytes)

    @property
    def rounds(self) -> int:
        """Rounds of resident blocks over the 132 SMs."""
        return -(-self.blocks // (SMS * self.blocks_per_sm))

    @property
    def blocks(self) -> int:
        """Blocks of one launch: one per (chain, segment)."""
        return self.chains * self.segments

    @property
    def ring_rows(self) -> int:
        """Row slots of the window ring: ``2 tile_h + carry_rows`` when a
        segment walks more than one strip and the larger ring costs no
        resident block (the next strip's fresh rows land while this one
        computes), else ``window_rows``."""
        base, ring = self.window_rows, 2 * self.tile_h + self.carry_rows
        if self.strips_per_segment > 1 and self._smem(ring) <= SMEM_PER_BLOCK \
                and self._resident(self._smem(ring)) \
                == self._resident(self._smem(base)):
            return ring
        return base

    @property
    def prefetch(self) -> bool:
        return self.ring_rows > self.window_rows

    @property
    def smem_bytes(self) -> int:
        return self._smem(self.ring_rows)

    # -- work and the least traffic ---------------------------------------

    @property
    def flops(self) -> int:
        return (2 * self.n * self.h_out * self.w_out * self.cout
                * self.kh * self.kw * self.cin_per_group)

    def min_bytes(self) -> int:
        """Bytes the function must move: each input read once (x and w at
        ``dtype_bytes``; the f32 or bf16 bias, or the int8 route's int32
        bias and f32 scale rows), the output (f32, or bf16 in bf16)
        written once."""
        if self.dtype_bytes == 2:
            return 2 * (self.n * self.h * self.w * self.cin
                        + self.kh * self.kw * self.cin_per_group * self.cout
                        + self.cout + self.n * self.h_out * self.w_out
                        * self.cout)
        rows = 1 if self.dtype_bytes == 4 else 2
        return (self.dtype_bytes
                * (self.n * self.h * self.w * self.cin
                   + self.kh * self.kw * self.cin_per_group * self.cout)
                + 4 * (rows * self.cout
                       + self.n * self.h_out * self.w_out * self.cout))

    # -- the paper's accounting modes (``repro/core/conv_plan.py:443``) ----

    def _mode_segments(self, mode: str | None) -> int:
        if mode is None:
            return self.segments
        if mode == "3dtrim":
            return 1
        if mode == "trim":
            return self.n_strips
        raise ValueError(f"unknown mode {mode!r}")

    def traffic_mode(self) -> str | None:
        """The accounting mode whose bytes this plan's schedule moves:
        ``"3dtrim"`` where a band is one carry chain, ``"trim"`` where
        every strip is a segment of its own (``halo``), else None: carry
        chains cut into several segments move bytes between the two.  A
        method, not a property, so that the plans'
        ``tools/plan_digest.py`` output stays as it was."""
        if self.segments == 1:
            return "3dtrim"
        if self.segments == self.n_strips:
            return "trim"
        return None

    def halo_rows(self, mode: str | None = None) -> int:
        """Input rows a chain re-reads from device memory: ``carry_rows``
        for every segment after its first.  ``"3dtrim"``: one carry
        segment a chain, none (the paper's shadow registers); ``"trim"``:
        one segment a strip, every strip after the first re-reads its
        ``carry_rows`` (what the halo kernel moves); ``None``: the plan's
        own ``segments``."""
        return (self._mode_segments(mode) - 1) * self.carry_rows

    def hbm_bytes(self, mode: str | None = None) -> dict:
        """Bytes the kernel's schedule moves: every chain (image,
        group, C_out tile, band) reads its band's window columns of each
        padded row once, plus ``carry_rows`` more for every segment after
        the first (a segment loads its first window whole: with ``halo``,
        one a strip, that is ``window_rows`` a strip); every strip
        streams its C_out tile's weights once; the output is written
        once (f32, or bf16 in bf16).  x and w at ``dtype_bytes``.
        ``mode`` prices the same tiles with the segments of
        :meth:`halo_rows`: ``"3dtrim"`` <= ``None`` <= ``"trim"``, and
        ``"trim"`` is the halo plan's bytes at these tiles."""
        db = self.dtype_bytes
        rows = (self.n_strips * self.tile_h
                + self._mode_segments(mode) * self.carry_rows)
        in_bytes = (db * self.chains * rows * self.window_cols
                    * self.cin_per_group)
        w_bytes = db * (self.n * self.n_bands * self.n_strips * self.kh
                        * self.kw * self.cin_per_group * self.cout)
        out_bytes = (2 if db == 2 else 4) * self.n * self.h_out \
            * self.w_out * self.cout
        return dict(input=in_bytes, weights=w_bytes, output=out_bytes,
                    total=in_bytes + w_bytes + out_bytes)

    def arithmetic_intensity(self, mode: str | None = None) -> float:
        """FLOPs per device-memory byte of :meth:`hbm_bytes` ``(mode)``."""
        return self.flops / max(self.hbm_bytes(mode)["total"], 1)


@dataclass(frozen=True)
class BF16ConvPlan(ConvPlan):
    """The :class:`ConvPlan` of the bf16 entries (``trim_conv2d_carry_bf16``
    / ``_halo_bf16``), from ``ConvPlan.build(..., dtype_bytes=2)``.  Its
    kernel route is :attr:`bf16_route` (:func:`bf16_route` of the layer):

    * ``"mma"`` — the implicit GEMM on the bf16 tensor cores: 8 warps of
      ``warps_m x warps_n`` (``warps_k`` 1: no split of the k axis), each
      with ``m_frags`` m16 x 4 n8 fragments; :attr:`k_steps` mma k-steps a
      strip (``KH x KW`` taps x ``Cin/g / 16``), :attr:`weight_stages` of
      :data:`BF16_MMA_STAGE_STEPS` each; the window's columns phase-split
      (:attr:`col_slots`), its pitch ``Cin/g + 8`` (an odd count of 16-byte
      quads) where it fits, its rows padded (:attr:`row_elems`).
    * ``"ffma"`` — the f32 kernel's threads and tiles on bf16 (the warp
      fields 0), the plan :class:`ConvPlan` made for it before.

    ``route`` stays ``"bf16"`` (the element type, as ``"f32"``); a class of
    its own keeps the f32 and int8 plans' fields and properties as they
    were."""

    def __post_init__(self):
        if self.dtype_bytes != 2:
            raise ValueError("BF16ConvPlan plans the bf16 entries "
                             "(dtype_bytes=2)")
        mma = self.bf16_route == "mma"
        warps = (self.warps_n, self.warps_k, self.m_frags)
        if not mma and warps != (0, 0, 0):
            raise ValueError(f"the bf16 ffma route takes no warps, got "
                             f"{warps}")
        if mma and not (self.warps_n in (1, 2, 4) and self.warps_k == 1
                        and 1 <= self.m_frags <= BF16_MMA_MAX_M_FRAGS
                        and self.tile_cout
                        <= BF16_MMA_WARP_N * self.warps_n):
            raise ValueError(
                f"the bf16 mma route takes warps_n in (1, 2, 4), warps_k 1, "
                f"1..{BF16_MMA_MAX_M_FRAGS} m16 fragments and tile_cout <= "
                f"{BF16_MMA_WARP_N} x warps_n; got warps_n={self.warps_n}, "
                f"warps_k={self.warps_k}, m_frags={self.m_frags}, "
                f"tile_cout={self.tile_cout}")
        super().__post_init__()

    @property
    def bf16_route(self) -> str:
        return bf16_route(self.cin_per_group, self.groups)

    @property
    def tensor_cores(self) -> bool:
        return self.bf16_route == "mma"

    @property
    def k_steps(self) -> int:
        """mma: the k-steps of one strip, each 16 channels of one tap in
        the order of ``csrc/bf16_mma.cuh``; ffma: 0."""
        if not self.tensor_cores:
            return 0
        return self.kh * self.kw * self.cin_per_group // BF16_MMA_K

    @property
    def weight_stages(self) -> int:
        """mma: weight-ring stages a strip; ffma: 0."""
        return -(-self.k_steps // BF16_MMA_STAGE_STEPS)

    @property
    def row_elems(self) -> int:
        """mma: elements of one window ring row, the columns plus the
        fewest 16-byte quads that make the next output row continue this
        one's bank-quad sequence (the int8 route's rule,
        :attr:`ConvPlan.row_bytes`); ffma: the columns."""
        cols = self.col_slots * self.cin_stride
        if not self.tensor_cores:
            return cols
        quads = self.cin_stride // 8
        return cols + 8 * next(
            (d for d in range(8)
             if (self.stride * (cols // 8 + d) - self.tile_w * quads) % 8
             == 0), 0)

    @property
    def row_bytes(self) -> int:
        return 2 * self.row_elems

    def _smem(self, ring_rows: int) -> int:
        if not self.tensor_cores:
            return super()._smem(ring_rows)
        # window ring, weight ring, epilogue staging (bf16)
        window = -(-ring_rows * self.row_elems // 8) * 8
        stages = (BF16_MMA_STAGES * BF16_MMA_STAGE_STEPS * BF16_MMA_K
                  * (BF16_MMA_WARP_N * self.warps_n + BF16_MMA_ROW_PAD))
        staging = BF16_MMA_WARPS * BF16_MMA_M * BF16_MMA_STAGING_PITCH
        return 2 * (window + stages + staging)


@functools.lru_cache(maxsize=4096)
def _build(x_shape, w_shape, stride, pads, groups, tile_h, tile_cout,
           dataflow, dtype_bytes) -> ConvPlan:
    n, h, w, cin = x_shape
    kh, kw, cin_pg, cout = w_shape
    if dtype_bytes == 1 and kh != kw:
        raise ValueError(f"the int8 kernel takes square kernels, got "
                         f"{kh}x{kw}")
    if cin_pg * groups != cin:
        raise ValueError(
            f"weights expect cin/groups={cin_pg} with groups={groups}, "
            f"input has cin={cin}")
    if cout % groups:
        raise ValueError(f"groups={groups} must divide cout={cout}")
    if stride < 1:
        raise ValueError(f"stride={stride} must be >= 1")
    h_out = (h + sum(pads[0]) - kh) // stride + 1
    w_out = (w + sum(pads[1]) - kw) // stride + 1
    if h_out < 1 or w_out < 1:
        raise ValueError("empty output: input smaller than kernel")
    if tile_h is not None and (tile_h < stride or tile_h % stride):
        raise ValueError(f"tile_h={tile_h} must be a positive multiple of "
                         f"the stride {stride}")
    cout_pg = cout // groups
    if tile_cout is not None:
        if tile_cout < 1:
            raise ValueError(f"tile_cout={tile_cout} must be >= 1")
        if min(tile_cout, cout_pg) > CONV_MAX_TILE_COUT:
            raise ValueError(f"tile_cout={tile_cout} exceeds "
                             f"{CONV_MAX_TILE_COUT}")
    base = dict(n=n, h=h, w=w, cin=cin, cout=cout, kh=kh, kw=kw,
                stride=stride, pads=pads, groups=groups, dataflow=dataflow,
                dtype_bytes=dtype_bytes)
    if dtype_bytes == 1 and q8_route(cin_pg, groups, kh) != "dp4a":
        return _build_q8(base, h_out, w_out, tile_h, tile_cout)
    if dtype_bytes == 2 and bf16_route(cin_pg, groups) == "mma":
        return _build_bf16_mma(base, h_out, w_out, tile_h, tile_cout)
    cls = BF16ConvPlan if dtype_bytes == 2 else ConvPlan
    if tile_cout is not None:
        tiles = [min(tile_cout, cout_pg)]
    else:   # a warp along C_out, or half a warp and twice the positions
        tiles = sorted({min(cout_pg, CONV_MAX_TILE_COUT),
                        min(cout_pg, CONV_MAX_TILE_COUT // 2)}, reverse=True)
    # padded pitch first (bank-conflict free), the plain one if it fits alone
    for pitch in _channel_pitches(cin_pg, dtype_bytes):
        best = None
        for tc in tiles:
            best = _best_tile(best, h_out, w_out, kw, stride, pitch, tile_h,
                              dict(base, tile_cout=tc), cls)
        if best is not None:
            return best[1]
    raise ValueError(
        f"no strip of tile_h={tile_h} fits {SMEM_PER_BLOCK} B of shared "
        f"memory at K={kh}x{kw}, Cin/groups={cin_pg}")


def _best_tile(best, h_out, w_out, kw, stride, pitch, tile_h, base,
               cls=None):
    """The better of ``best`` and every (band, strip) of one C_out tile
    and channel pitch, as ``(key, plan)``: the fewest strips the busiest
    SM walks (each a full pass of the slots: 8,192 outputs whatever the
    C_out tile, so ragged edges, idle slots and SMs left without a block
    all count), then the fewest window pixels read per output, then the
    widest band.  ``cls``: the plan class (ConvPlan or, for bf16,
    :class:`BF16ConvPlan`)."""
    cls = cls or ConvPlan
    probe = cls(tile_h=stride, tile_w=1, cin_stride=pitch, **base)
    slots, kc = probe.slots, probe.carry_rows
    for tile_w in range(1, min(w_out, slots, CONV_MAX_TILE_W) + 1):
        if tile_h is not None:
            # an oversized strip is clamped to the full height
            rows = [min(tile_h, h_out * stride) // stride]
        else:
            rows = range(1, min(h_out, slots // tile_w) + 1)
        cols = (tile_w - 1) * stride + kw
        for th_out in rows:
            if th_out * tile_w > slots:
                continue
            if _smem_bytes((th_out * stride + kc) * cols * pitch,
                           probe.threads_cout,
                           probe.dtype_bytes) > SMEM_PER_BLOCK:
                continue
            plan = cls(tile_h=th_out * stride, tile_w=tile_w,
                       cin_stride=pitch, **base)
            steps = -(-plan.blocks // SMS) * plan.strips_per_segment
            read = plan.window_rows * cols / plan.positions
            key = (steps, read, -tile_w)
            if best is None or key < best[0]:
                best = (key, plan)
    return best


def _q8_strip_clocks(p: ConvPlan) -> float:
    """SM clocks of one strip of one block of the int8 tensor-core routes
    under the plan's latency model: the warp's k-steps, then its m16
    fragments' epilogues."""
    return p.k_steps * Q8_KSTEP_CLOCKS + p.m_frags * Q8_EPILOGUE_CLOCKS


def _q8_bands(w_out: int, slots: int) -> list:
    """Band widths the int8 plan tries: each width that changes the band
    count (``ceil(w_out / b)``) and the multiples of 8, up to the slots
    and :data:`CONV_MAX_TILE_W`."""
    top = min(w_out, slots, CONV_MAX_TILE_W)
    widths = {-(-w_out // b) for b in range(1, w_out + 1)}
    widths |= set(range(8, top + 1, 8))
    return sorted(v for v in widths if v <= top)


def _build_q8(base: dict, h_out: int, w_out: int, tile_h, tile_cout
              ) -> ConvPlan:
    """The int8 tensor-core routes' plan.  For each C_out tile (the given
    one, else :data:`Q8_TILE_COUTS` capped at Cout/g; ``warps_n`` the
    fewest warps of 32 channels that hold it), each warp layout and M
    tile (``warps_k`` > 1 only with one m16 fragment a warp: the small
    tiles) and each band width: the tallest strip the M tile holds (or the
    given ``tile_h``).  Of the plans whose window fits
    :data:`SMEM_PER_BLOCK`, those with at least one block an SM first,
    then the fewest clocks (:attr:`ConvPlan.rounds` of resident blocks,
    which overlap, each of ``strips_per_segment`` strips of
    :func:`_q8_strip_clocks`), then the fewest window pixels read per
    output element (a C_out tile re-reads the window), then the widest
    band."""
    k, stride = base["kh"], base["stride"]
    cin_pg = base["cin"] // base["groups"]
    cout_pg = base["cout"] // base["groups"]
    route = q8_route(cin_pg, base["groups"], k)
    pitches = (_q8_mma_pitches(cin_pg) if route == "mma"
               else [q8_cin4(cin_pg)])
    tiles = ([min(tile_cout, cout_pg)] if tile_cout is not None
             else sorted({min(cout_pg, c) for c in Q8_TILE_COUTS},
                         reverse=True))
    for pitch in pitches:
        best = None
        for tc in tiles:
            wn = 1 if tc <= Q8_WARP_N else 2 if tc <= 2 * Q8_WARP_N else 4
            for wk in (1, 2, 4):
                if wn * wk > Q8_WARPS:
                    continue
                wm = Q8_WARPS // (wn * wk)
                for mi in (range(1, Q8_MAX_M_FRAGS + 1) if wk == 1 else (1,)):
                    slots = Q8_MMA_M * mi * wm
                    for tile_w in _q8_bands(w_out, slots):
                        if tile_h is not None:
                            th_out = min(tile_h, h_out * stride) // stride
                        else:
                            th_out = min(h_out, slots // tile_w)
                        if th_out * tile_w > slots:
                            continue
                        plan = ConvPlan(tile_h=th_out * stride, tile_w=tile_w,
                                        tile_cout=tc, cin_stride=pitch,
                                        warps_n=wn, warps_k=wk, m_frags=mi,
                                        **base)
                        if plan._smem(plan.window_rows) > SMEM_PER_BLOCK:
                            continue
                        clocks = (plan.rounds * plan.strips_per_segment
                                  * _q8_strip_clocks(plan))
                        read = plan.window_rows * plan.window_cols \
                            / (plan.positions * tc)
                        key = (plan.blocks < SMS, clocks, read, -tile_w)
                        if best is None or key < best[0]:
                            best = (key, plan)
        if best is not None:
            return best[1]
    raise ValueError(
        f"no strip of tile_h={tile_h} fits {SMEM_PER_BLOCK} B of shared "
        f"memory at K={k}, Cin/groups={cin_pg} (int8 {route} route)")


def mma_strip_clocks(p: ConvPlan) -> float:
    """SM clocks of one strip of one block of a tensor-core route (int8
    mma / im2col, bf16 mma) under its plan's latency model: the warp's
    k-steps (bf16: each with the weight copies of the block's
    ``warps_n`` x 32 channels), then its m16 fragments' epilogues."""
    if p.dtype_bytes == 2:
        return (p.k_steps * (BF16_MMA_KSTEP_CLOCKS
                             + BF16_MMA_COPY_CLOCKS * p.warps_n)
                + p.m_frags * BF16_MMA_EPILOGUE_CLOCKS)
    return _q8_strip_clocks(p)


def _build_bf16_mma(base: dict, h_out: int, w_out: int, tile_h, tile_cout
                    ) -> ConvPlan:
    """The bf16 mma route's plan, :func:`_build_q8`'s search without a
    split of the k axis: for each C_out tile (the given one, else
    :data:`BF16_TILE_COUTS` capped at Cout/g; ``warps_n`` the fewest warps
    of 32 channels that hold it), each M tile (``m_frags``) and each band
    width, the tallest strip the M tile holds (or the given ``tile_h``).
    Of the plans whose window fits :data:`SMEM_PER_BLOCK`: at least one
    block an SM first, then the fewest clocks of the latency model
    (:func:`mma_strip_clocks`), then the fewest window pixels read per
    output element, then the widest band.  The tiles move no k-step: every
    plan takes each output's k-steps in the one order of
    ``csrc/bf16_mma.cuh``."""
    stride = base["stride"]
    cin_pg = base["cin"] // base["groups"]
    cout_pg = base["cout"] // base["groups"]
    pitches = [cin_pg + 8, cin_pg]     # odd 16-byte quads, then the plain
    tiles = ([min(tile_cout, cout_pg)] if tile_cout is not None
             else sorted({min(cout_pg, c) for c in BF16_TILE_COUTS},
                         reverse=True))
    for pitch in pitches:
        best = None
        for tc in tiles:
            if tc > BF16_MMA_WARP_N * 4:
                continue
            wn = 1 if tc <= BF16_MMA_WARP_N else \
                2 if tc <= 2 * BF16_MMA_WARP_N else 4
            wm = BF16_MMA_WARPS // wn
            for mi in range(1, BF16_MMA_MAX_M_FRAGS + 1):
                slots = BF16_MMA_M * mi * wm
                for tile_w in _q8_bands(w_out, slots):
                    if tile_h is not None:
                        th_out = min(tile_h, h_out * stride) // stride
                    else:
                        th_out = min(h_out, slots // tile_w)
                    if th_out * tile_w > slots:
                        continue
                    plan = BF16ConvPlan(tile_h=th_out * stride, tile_w=tile_w,
                                        tile_cout=tc, cin_stride=pitch,
                                        warps_n=wn, warps_k=1, m_frags=mi,
                                        **base)
                    if plan._smem(plan.window_rows) > SMEM_PER_BLOCK:
                        continue
                    clocks = (plan.rounds * plan.strips_per_segment
                              * mma_strip_clocks(plan))
                    read = plan.window_rows * plan.window_cols \
                        / (plan.positions * tc)
                    key = (plan.blocks < SMS, clocks, read, -tile_w)
                    if best is None or key < best[0]:
                        best = (key, plan)
        if best is not None:
            return best[1]
    raise ValueError(
        f"no strip of tile_h={tile_h} fits {SMEM_PER_BLOCK} B of shared "
        f"memory at K={base['kh']}x{base['kw']}, Cin/groups={cin_pg} (bf16 "
        f"mma route)")


# ---------------------------------------------------------------------------
# Backward geometry
# ---------------------------------------------------------------------------

def input_grad_geometry(x_shape, w_shape, *, stride: int = 1, pad=0,
                        groups: int = 1) -> dict:
    """Geometry of the input-gradient conv of one forward problem (the
    counterpart of ``repro/core/conv_plan.py:505``).

    The input cotangent of ``y = conv(x, w, stride, pads)`` is a stride-1
    convolution of the stride-dilated cotangent with the flipped,
    transposed weights.  The JAX version takes a symmetric ``pad`` (it
    pre-pads 'same' itself); here ``pad`` is ``((top, bottom), (left,
    right))``, asymmetric for XLA 'same' at stride 2, and the edge pads
    that come back are passed to the forward kernel as virtual pads:

        pad_h = (KH-1-top, KH-1-bottom + r_h),  r_h = (H+top+bottom-KH) % s

    and likewise for the width with KW, so that the result has ``x``'s
    shape (a rectangular sub-kernel of the kernel tiling gets pads of its
    own extent on each axis).  Each forward pad must be <= its axis's
    extent - 1 (true for 'same' and 'valid').

    Returns ``h_out``/``w_out`` (the cotangent's), the dilated cotangent
    shape ``g_dilated_shape``, the edge pads ``pad_h``/``pad_w``, the
    padded shape ``g_padded_shape`` and ``wt_shape = (KH, KW, Cout/groups,
    Cin)``.
    """
    n, h, w, cin = x_shape
    kh, kw, cin_pg, cout = w_shape
    if cin_pg * groups != cin:
        raise ValueError(
            f"weights expect cin/groups={cin_pg} with groups={groups}, "
            f"input has cin={cin}")
    (pt, pb), (pl, pr) = pads = normalize_pad(pad)
    if max(pt, pb) > kh - 1 or max(pl, pr) > kw - 1:
        raise ValueError(f"input-grad conv requires every pad <= K-1, got "
                         f"pads={pads} for K=({kh}, {kw})")
    s = stride
    h_out = (h + pt + pb - kh) // s + 1
    w_out = (w + pl + pr - kw) // s + 1
    if h_out < 1 or w_out < 1:
        raise ValueError("empty output: input smaller than kernel")
    hd, wd = (h_out - 1) * s + 1, (w_out - 1) * s + 1
    pad_h = (kh - 1 - pt, kh - 1 - pb + (h + pt + pb - kh) % s)
    pad_w = (kw - 1 - pl, kw - 1 - pr + (w + pl + pr - kw) % s)
    return dict(
        h_out=h_out, w_out=w_out, stride=s,
        g_dilated_shape=(n, hd, wd, cout),
        g_padded_shape=(n, hd + sum(pad_h), wd + sum(pad_w), cout),
        pad_h=pad_h, pad_w=pad_w,
        wt_shape=(kh, kw, cout // groups, cin),
    )


WGRAD_THREADS = 256           # threads per block (kThreads)
WGRAD_TILE_ROWS = 128         # rows of the flattened (ki, kj, ci) axis
WGRAD_TILE_COUT = 128         # output channels per block (kTileCout) ...
WGRAD_NARROW_TILE_COUT = 64   # ... or this where Cout/groups <= 64
WGRAD_BLOCKS_PER_SM = 2       # __launch_bounds__(kThreads, 2)
WGRAD_SLOTS = SMS * WGRAD_BLOCKS_PER_SM   # resident GEMM blocks: 264
WGRAD_MIN_CHUNK_POSITIONS = 256
WGRAD_WORKSPACE_CAP = 256 * 2**20   # bytes of per-chunk partial sums
WGRAD_DW_BLOCKS = 4 * SMS * (2048 // WGRAD_THREADS)   # depthwise: 4 full
                              # waves of resident blocks (8 an SM)
# The routes, in the launcher's order (enum WgradRoute)
WGRAD_ROUTES = ("gemm", "depthwise", "mma")
# Route mma (bf16 operands on the bf16 tensor cores; kMma* of the .cu)
WGRAD_MMA_TILE_ROWS = 128     # rows a block (kMmaTileRows)
WGRAD_MMA_POSITIONS = 64      # cotangent positions a ring stage: 4 k-steps
WGRAD_MMA_STAGES = 3          # stages of its cp.async ring (kMmaStages)
WGRAD_MMA_BLOCKS_PER_SM = 2   # __launch_bounds__(kThreads, 2)
WGRAD_MMA_SLOTS = SMS * WGRAD_MMA_BLOCKS_PER_SM   # resident mma blocks
WGRAD_MMA_PITCH_PAD = 8       # bf16 past each staged row (kBf16RowPad: an
                              # odd count of 16-byte quads)


def wgrad_route(cin: int, cout: int, groups: int, dtype_bytes: int) -> str:
    """The weight-gradient kernel's route for a layer: ``"depthwise"``
    where groups == Cin == Cout; on bf16 operands ``"mma"`` (the bf16
    tensor cores) where Cin/g is a multiple of 16 and Cout/g of 8; else
    ``"gemm"`` (the FFMA loop; bf16 widened into its f32 stages).  A
    function of the layer alone: the launcher checks it."""
    if groups == cin == cout:
        return "depthwise"
    if (dtype_bytes == 2 and (cin // groups) % BF16_MMA_K == 0
            and (cout // groups) % BF16_MMA_N == 0):
        return "mma"
    return "gemm"


def _wgrad_seconds(rows: int, w_out: int, tiles: int, tile_flops: int,
                   dw_elems: int, t: int, slots: int, peak: float) -> float:
    """The GEMM routes' time model at a chunk height of ``t`` cotangent
    rows: ``ceil(blocks / slots)`` rounds of blocks that each do
    ``tile_flops`` per position of the largest chunk at one slot's share
    of ``peak`` (route gemm: :data:`WGRAD_SLOTS` at 67 TFLOP/s of FFMA;
    route mma: :data:`WGRAD_MMA_SLOTS` at 989 TFLOP/s of bf16), plus the
    workspace's traffic (partials written and read, dw written) at
    3.35 TB/s."""
    chunks = -(-rows // t)
    rounds = -(-tiles * chunks // slots)
    ops_s = rounds * t * w_out * tile_flops * slots / peak
    ws_s = 0 if chunks == 1 else \
        (2 * chunks + 1) * 4 * dw_elems / PEAK_BYTES_PER_S
    return ops_s + ws_s


@functools.lru_cache(maxsize=None)
def _wgrad_chunk_rows(rows: int, w_out: int, tiles: int, tile_flops: int,
                      dw_elems: int, min_rows: int, slots: int,
                      peak: float) -> int:
    """The GEMM routes' chunk height (cotangent rows) from ``min_rows`` up
    that minimises :func:`_wgrad_seconds`.  Ties go to the taller chunk
    (less workspace)."""
    best = None
    for t in range(rows, min_rows - 1, -1):
        sec = _wgrad_seconds(rows, w_out, tiles, tile_flops, dw_elems, t,
                             slots, peak)
        if best is None or sec < best[0]:
            best = (sec, t)
    return best[1]


def _wgrad_min_rows(rows: int, w_out: int, dw_elems: int) -> tuple:
    """(the workspace cap's least chunk height, the GEMM route's least
    chunk height: at least :data:`WGRAD_MIN_CHUNK_POSITIONS` positions
    and the cap's)."""
    max_chunks = max(1, WGRAD_WORKSPACE_CAP // (4 * dw_elems))
    cap_rows = min(rows, -(-rows // max_chunks))
    return cap_rows, max(min(rows, -(-WGRAD_MIN_CHUNK_POSITIONS // w_out)),
                         cap_rows)


@dataclass(frozen=True)
class WeightGradPlan:
    """Launch geometry of the weight-gradient kernel
    (``kernels/csrc/trim_conv2d_wgrad.cu``); the Hopper counterpart of
    ``repro/core/conv_plan.py:552``.

        dw[ki, kj, ci, g*Cpg+co] = sum_{n, oh, ow}
            xpad[n, oh*s+ki, ow*s+kj, g*Cin_pg+ci] * dz[n, oh, ow, g*Cpg+co]

    Per group, dw is a ``(KH*KW*Cin_pg) x Cpg`` matrix whose rows are the
    flattened ``(ki, kj, ci)`` axis (``KH x KW``: a rectangular sub-kernel
    of the kernel tiling as well as a square kernel).  Two routes:

    * ``"gemm"`` — a block owns a tile of :data:`WGRAD_TILE_ROWS` rows x
      :data:`WGRAD_TILE_COUT` columns of it (:data:`WGRAD_NARROW_TILE_COUT`
      where ``Cout/g <= 64``) and one *chunk* of the reduction;
    * ``"depthwise"`` (``groups == Cin == Cout``: 9 rows and one column a
      group at K = 3) — a thread owns one (tap, channel) element, lanes
      along the channels, :data:`WGRAD_THREADS` elements a block.

    The TPU plan sweeps ``(n, strip of tile_go cotangent rows)`` in
    sequence into one resident accumulator.  Here the sweep is cut into
    chunks that run in parallel: a chunk is a run of ``tile_go``
    consecutive rows of the flattened ``(n, oh)`` cotangent axis (it may
    cross an image boundary; the last may be shorter).  Each chunk writes
    its partial dw into a workspace, and a second pass sums the partials
    in ascending chunk order.  ``tile_go`` — and so the chunk count — is
    a pure function of the shape.  GEMM route: at least
    :data:`WGRAD_MIN_CHUNK_POSITIONS` positions a chunk, then the height
    that minimises :func:`_wgrad_chunk_rows`'s model, which fills the
    card's :data:`WGRAD_SLOTS` resident blocks in whole rounds (VGG-16
    conv2 at batch 8: 5 tiles x 52 chunks = 260 blocks, 7.7 MB of
    partials).  Depthwise route: enough chunks for
    :data:`WGRAD_DW_BLOCKS` blocks.  Either way the workspace stays
    within :data:`WGRAD_WORKSPACE_CAP`; with one chunk there is none and
    the kernel writes dw itself.

    The element size of x, the cotangent and dw is the class's
    ``dtype_bytes`` (4 here; :class:`BF16WeightGradPlan`, from
    ``build(..., dtype_bytes=2)``, for the bf16 entry).  On routes gemm
    and depthwise only the byte counts depend on it: the bf16 entry
    widens its operands into the f32 kernel's stages, so it runs the f32
    geometry, chunks and f32 partials.  A bf16 layer on route ``"mma"``
    (:func:`wgrad_route`) runs the bf16 tensor cores: tiles of
    :data:`WGRAD_MMA_TILE_ROWS` rows, and chunks from the time model at
    :data:`WGRAD_MMA_SLOTS` resident blocks and 989 TFLOP/s.  An f32
    plan prints as it did before.
    """

    dtype_bytes: ClassVar[int] = 4

    n: int
    h: int
    w: int
    cin: int
    cout: int
    kh: int
    kw: int
    stride: int
    pads: tuple
    groups: int
    tile_go: int

    @classmethod
    def build(cls, x_shape, w_shape, *, stride: int = 1, pad=0,
              groups: int = 1, tile_go: int | None = None,
              dtype_bytes: int = 4) -> "WeightGradPlan":
        """Plan from the forward problem's shapes; ``tile_go`` overrides
        the chunk height (cotangent rows) and is raised to the cap.
        ``dtype_bytes=2`` gives the :class:`BF16WeightGradPlan` of the
        same geometry."""
        if dtype_bytes not in _WGRAD_PLANS:
            raise ValueError(f"dtype_bytes={dtype_bytes}: the weight-"
                             "gradient kernel takes f32 (4) or bf16 (2)")
        cls = _WGRAD_PLANS[dtype_bytes]
        n, h, w, cin = x_shape
        kh, kw, cin_pg, cout = w_shape
        if cin_pg * groups != cin:
            raise ValueError(
                f"weights expect cin/groups={cin_pg} with groups={groups}, "
                f"input has cin={cin}")
        if cout % groups:
            raise ValueError(f"groups={groups} must divide cout={cout}")
        if stride < 1:
            raise ValueError(f"stride={stride} must be >= 1")
        pads = normalize_pad(pad)
        h_out = (h + sum(pads[0]) - kh) // stride + 1
        w_out = (w + sum(pads[1]) - kw) // stride + 1
        if h_out < 1 or w_out < 1:
            raise ValueError("empty output: input smaller than kernel")
        if tile_go is not None and tile_go < 1:
            raise ValueError(f"tile_go={tile_go} must be >= 1")
        dw_elems = kh * kw * cin_pg * cout
        rows = n * h_out
        cap_rows, min_rows = _wgrad_min_rows(rows, w_out, dw_elems)
        plan = cls(n=n, h=h, w=w, cin=cin, cout=cout, kh=kh, kw=kw,
                   stride=stride, pads=pads, groups=groups, tile_go=rows)
        if tile_go is None:
            if plan.route == "depthwise":
                chunks = -(-WGRAD_DW_BLOCKS // plan.tiles)
                tile_go = -(-rows // chunks)
            else:
                flops, slots, peak = plan._model()
                tile_go = _wgrad_chunk_rows(rows, w_out, plan.tiles, flops,
                                            dw_elems, min_rows, slots, peak)
        tile_go = min(max(tile_go, cap_rows), rows)
        return cls(n=n, h=h, w=w, cin=cin, cout=cout, kh=kh, kw=kw,
                   stride=stride, pads=pads, groups=groups, tile_go=tile_go)

    @property
    def cin_per_group(self) -> int:
        return self.cin // self.groups

    @property
    def cout_per_group(self) -> int:
        return self.cout // self.groups

    @property
    def route(self) -> str:
        """:func:`wgrad_route` of the layer: ``"depthwise"`` where groups
        == Cin == Cout, else ``"gemm"`` (f32; :class:`BF16WeightGradPlan`
        adds ``"mma"``).  The wrapper passes it, :attr:`tile_cout` and
        :attr:`blocks` to the kernel's launcher, which launches what they
        say and refuses a route or a block count that the layer and its
        own tile constants do not give."""
        return wgrad_route(self.cin, self.cout, self.groups,
                           self.dtype_bytes)

    def _model(self) -> tuple:
        """(FLOPs a block does a position, resident blocks, peak FLOP/s)
        of the route's time model (:func:`_wgrad_seconds`).  Route mma is
        priced at the nominal bf16 peak, not at the 117-251 TFLOP/s the
        card gives it per VGG-16 layer (``chip_smoke.py``): the chunk
        heights this gives (one chunk of 144 blocks for conv9-13 at N=8)
        have not been checked against others on the card."""
        if self.route == "mma":
            return (2 * WGRAD_MMA_TILE_ROWS * self.tile_cout,
                    WGRAD_MMA_SLOTS, PEAK_BF16_FLOPS)
        return 2 * WGRAD_TILE_ROWS * self.tile_cout, WGRAD_SLOTS, \
            PEAK_F32_FLOPS

    def model_seconds(self, tile_go: int | None = None) -> float:
        """:func:`_wgrad_seconds` of the plan's route at a chunk height of
        ``tile_go`` cotangent rows (the plan's own by default)."""
        flops, slots, peak = self._model()
        return _wgrad_seconds(self.n * self.h_out, self.w_out, self.tiles,
                              flops, self.dw_elems,
                              self.tile_go if tile_go is None else tile_go,
                              slots, peak)

    @property
    def tile_cout(self) -> int:
        """GEMM route: the block tile's columns."""
        return WGRAD_NARROW_TILE_COUT \
            if self.cout_per_group <= WGRAD_NARROW_TILE_COUT \
            else WGRAD_TILE_COUT

    @property
    def tiles(self) -> int:
        """Blocks a chunk: GEMM tiles over all groups, or depthwise blocks
        of :data:`WGRAD_THREADS` (tap, channel) elements."""
        if self.route == "depthwise":
            return -(-self.dw_elems // WGRAD_THREADS)
        tile_rows = WGRAD_MMA_TILE_ROWS if self.route == "mma" \
            else WGRAD_TILE_ROWS
        return (self.groups * -(-self.rows // tile_rows)
                * -(-self.cout_per_group // self.tile_cout))

    @property
    def blocks(self) -> int:
        """Blocks of the partial (or only) launch."""
        return self.tiles * self.chunks

    @property
    def h_out(self) -> int:
        return (self.h + sum(self.pads[0]) - self.kh) // self.stride + 1

    @property
    def w_out(self) -> int:
        return (self.w + sum(self.pads[1]) - self.kw) // self.stride + 1

    @property
    def dw_shape(self) -> tuple[int, int, int, int]:
        return (self.kh, self.kw, self.cin_per_group, self.cout)

    @property
    def rows(self) -> int:
        """Rows of the flattened (ki, kj, ci) axis: KH*KW*Cin/groups."""
        return self.kh * self.kw * self.cin_per_group

    @property
    def chunks(self) -> int:
        return -(-self.n * self.h_out // self.tile_go)

    @property
    def dw_elems(self) -> int:
        return self.rows * self.cout

    @property
    def workspace_bytes(self) -> int:
        """Per-chunk partial sums; none with a single chunk."""
        return 0 if self.chunks == 1 else 4 * self.chunks * self.dw_elems

    @property
    def flops(self) -> int:
        return (2 * self.n * self.h_out * self.w_out * self.cout
                * self.rows)

    def min_bytes(self) -> int:
        """Bytes the function must move at ``dtype_bytes`` an element:
        x and the cotangent read once, dw written once."""
        elems = (self.n * self.h * self.w * self.cin
                 + self.n * self.h_out * self.w_out * self.cout
                 + self.dw_elems)
        return self.dtype_bytes * elems


@dataclass(frozen=True)
class BF16WeightGradPlan(WeightGradPlan):
    """The :class:`WeightGradPlan` of the bf16 entry
    (``trim_conv2d_wgrad_bf16``): bf16 x, cotangent and dw, f32 partials;
    the f32 geometry on routes gemm and depthwise, its own tiles and
    chunks on route mma."""

    dtype_bytes = 2


_WGRAD_PLANS = {4: WeightGradPlan, 2: BF16WeightGradPlan}


# ---------------------------------------------------------------------------
# 1-D plan (causal depthwise conv: the Mamba / RG-LRU temporal mixing)
# ---------------------------------------------------------------------------

# The conv1d forward kernel (trim_conv1d.cu; also the input gradient)
CONV1D_LANES = 32             # threads a block: one warp (kLanes)
CONV1D_VEC = {4: 4, 2: 8}     # channels a lane where rows are 16-byte
                              # aligned, by element size (kVecF32, kVecBf16)
CONV1D_AHEAD = 8              # rows of a load batch (kAhead); the next
                              # batch is in flight while one sums
CONV1D_RESIDENT_WARPS = 12    # blocks (warps) an SM the kernel's launch
                              # bounds keep resident (kMinBlocks)
CONV1D_TILE_LS = (256, 128, 64, 32, 16, 8)   # run lengths, longest first
CONV1D_HALO_SHARE = 0.2       # a run re-reads at most this share of its
                              # rows as halo (K-1 rows a run)
CONV1D_HBM_LATENCY_S = 1e-6   # HBM latency under load, for Little's law
# Bytes to keep in flight on each SM to stream at the HBM rate (Little's
# law: rate x latency over the SMs): 25,379
CONV1D_INFLIGHT_BYTES = PEAK_BYTES_PER_S * CONV1D_HBM_LATENCY_S / SMS
CONV1D_UNROLLED_K = 8         # K = 2..8 keep the window in registers (a
                              # template instance each); larger K runs the
                              # kernel's runtime-K instance
# The conv1d weight-gradient kernel (trim_conv1d_wgrad.cu)
CONV1D_WGRAD_RUNS = 4         # runs (warps) a block (kRuns)
CONV1D_WGRAD_LANES = 32       # channel vectors (lanes) a warp (kLanes)
CONV1D_WGRAD_VEC = {4: 4, 2: 8}   # channels a lane where rows are 16-byte
                              # aligned, by element size (kVecF32, kVecBf16)
CONV1D_WGRAD_UNROLL = 4       # rows of x and dy a load batch (kUnroll);
                              # the next batch is in flight while one sums
CONV1D_WGRAD_TILE_LS = (256, 128, 64, 32, 16, 8)   # run lengths
CONV1D_WGRAD_HALO_SHARE = 0.1  # a run re-reads at most this share of its
                               # rows as halo (K-1 rows a run)
CONV1D_WGRAD_MIN_BLOCKS = 2 * SMS   # blocks to aim for: every SM busy,
                                    # the whole grid resident at once
CONV1D_WGRAD_SUM_THREADS = 256   # threads a block of the partials' sum
CONV1D_WGRAD_MAX_SMEM = 232448   # H100: 227 KB opt-in a block


@dataclass(frozen=True)
class Conv1dPlan:
    """Launch geometry of the causal depthwise conv1d kernel
    (``kernels/csrc/trim_conv1d.cu``; also its input gradient, launched
    on the reversed cotangent); the Hopper counterpart of
    ``repro/core/conv_plan.py:759``.

        y[b, t, d] = sum_{i < K} x[b, t-K+1+i, d] * w[i, d]

    The TPU plan sweeps chunks of 512 steps in order on one core, carrying
    the ``K-1`` boundary rows in VMEM, with 1024-lane channel tiles.  On
    the card blocks run in parallel and in no order, so nothing carries
    between them.  Here a block is one warp, and the warp owns one *run*
    of ``tile_l`` timesteps of one sequence over one *channel warp* of
    ``tile_d`` = 32 ``vec`` consecutive channels: a lane owns ``vec``
    channels, one 16-byte vector a row where rows are 16-byte aligned
    (:data:`CONV1D_VEC`: 4 f32 or 8 bf16 channels), else one.  The
    channel warps tile D from its start, so the only lanes that idle are
    those of a row's last channel warp past D, and only when D is not a
    multiple of ``tile_d`` (at D = 2560: 20 f32 or 10 bf16 warps, none
    idle).  The grid is ``(runs x channel warps, B)``, one block a warp.

    A lane keeps the ``K-1`` previous inputs of its channels in registers
    (the shadow registers) while it walks its run, and keeps two batches
    of :data:`CONV1D_AHEAD` rows in flight; for K >
    :data:`CONV1D_UNROLLED_K` the kernel re-reads them through L1
    instead.  A run's first ``K-1`` inputs are re-read (zeros before t =
    0): that halo is what :meth:`hbm_bytes` prices beyond the least
    traffic, as device-memory bytes (an upper bound: most come from the
    L2), the JAX plan's ``"trim"`` mode.

    ``tile_l`` comes from bytes.  It is the shortest run of
    :data:`CONV1D_TILE_LS` whose ``K-1`` re-read halo rows stay within
    :data:`CONV1D_HALO_SHARE` of it (16 steps at K = 4): a warp then has
    its whole run in flight in its first two load batches, and the grid
    keeps the most warps streaming, several times the
    :data:`CONV1D_INFLIGHT_BYTES` on each SM that cover the latency of
    device memory (Little's law at 3.35 TB/s and
    :data:`CONV1D_HBM_LATENCY_S`; :attr:`inflight_bytes`), with a short
    last wave.  A longer run saves only halo rows that the previous run's
    warp, scheduled beside it in the run-major grid, has just brought
    into the L2; measured on the H100 (``tools/conv1d_fwd_ablation.py``),
    runs of 32-256 steps read up to 1.4x (f32) and 2x (bf16) slower at
    the main-path rows.

    ``dtype_bytes`` 2 is the bf16 route (``trim_conv1d_bf16``: bf16 in
    and out, the same f32 sums); the byte counts follow the element size.
    """

    b: int
    length: int
    d: int
    k: int
    tile_l: int
    dtype_bytes: int = 4
    vec: int = 1

    @classmethod
    def build(cls, x_shape, w_shape, *, tile_l: int | None = None,
              dtype_bytes: int = 4, vec: int = 1) -> "Conv1dPlan":
        """Plan from ``x (B, L, D)``, ``w (K, D)``, the element size (4:
        f32, 2: bf16) and the channels a lane (1, or
        ``CONV1D_VEC[dtype_bytes]`` with D a multiple of it), choosing
        ``tile_l`` if it is left as ``None``.  Raises ``ValueError`` for
        what the kernel cannot take, so every plan it returns is one the
        kernel runs."""
        if len(x_shape) != 3 or len(w_shape) != 2:
            raise ValueError(f"x must be (B, L, D) and w (K, D); got "
                             f"{tuple(x_shape)} and {tuple(w_shape)}")
        b, length, d = (int(v) for v in x_shape)
        k, wd = (int(v) for v in w_shape)
        if wd != d:
            raise ValueError(f"w has {wd} channels, x has {d}")
        if min(b, length, d) < 1:
            raise ValueError(f"empty input {tuple(x_shape)}: B, L and D "
                             "must be >= 1")
        if b > 65535:
            raise ValueError(f"B={b} > 65535, the grid's y limit")
        if k < 2:
            raise ValueError(f"K={k}: the kernel takes K >= 2 "
                             "(ops.depthwise_conv1d routes K < 2 to the "
                             "oracle)")
        if dtype_bytes not in CONV1D_VEC or vec not in (
                1, CONV1D_VEC[dtype_bytes]) or d % vec:
            raise ValueError(
                f"dtype_bytes={dtype_bytes}, vec={vec}: the kernel takes "
                "f32 (4) with vec 1 or 4 and bf16 (2) with vec 1 or 8, D a "
                "multiple of vec")
        if tile_l is None:
            fits = [t for t in CONV1D_TILE_LS
                    if k - 1 <= CONV1D_HALO_SHARE * t] \
                or [CONV1D_TILE_LS[0]]
            tile_l = min(fits[-1], length)
        if tile_l < 1:
            raise ValueError(f"tile_l={tile_l} must be >= 1")
        return cls(b=b, length=length, d=d, k=k, tile_l=tile_l,
                   dtype_bytes=dtype_bytes, vec=vec)

    @property
    def tile_d(self) -> int:
        """Channels a block (a channel warp): 32 lanes of ``vec``."""
        return CONV1D_LANES * self.vec

    @property
    def threads(self) -> int:
        """Threads a block: one warp."""
        return CONV1D_LANES

    @property
    def d_warps(self) -> int:
        """Channel warps across D; only the last may hold idle lanes."""
        return -(-self.d // self.tile_d)

    @property
    def runs(self) -> int:
        return -(-self.length // self.tile_l)

    @property
    def grid(self) -> tuple[int, int]:
        """(runs x channel warps, B): block x is run x // d_warps over
        channel warp x % d_warps."""
        return (self.runs * self.d_warps, self.b)

    @property
    def blocks(self) -> int:
        """Blocks, each one warp."""
        return self.b * self.runs * self.d_warps

    @property
    def warp_inflight_bytes(self) -> int:
        """Bytes a warp keeps in flight: two batches of
        :data:`CONV1D_AHEAD` rows of its 32 lanes' ``vec`` channels."""
        return 2 * CONV1D_AHEAD * CONV1D_LANES * self.vec * self.dtype_bytes

    @property
    def inflight_bytes(self) -> float:
        """Bytes in flight on an SM: the grid's warps an SM, at most the
        :data:`CONV1D_RESIDENT_WARPS` the launch bounds keep resident,
        times :attr:`warp_inflight_bytes`."""
        return min(self.blocks / SMS, CONV1D_RESIDENT_WARPS) \
            * self.warp_inflight_bytes

    @property
    def halo_rows(self) -> int:
        """Input rows re-read per (batch, channel): run r >= 1 re-reads
        the ``min(K-1, r * tile_l)`` rows before it."""
        return sum(min(self.k - 1, r * self.tile_l)
                   for r in range(1, self.runs))

    @property
    def halo_share(self) -> float:
        """Re-read rows over the rows of the sequence."""
        return self.halo_rows / self.length

    @property
    def flops(self) -> int:
        return 2 * self.b * self.length * self.d * self.k

    def min_bytes(self) -> int:
        """Bytes the function must move: x and w read once, y written
        once, ``dtype_bytes`` an element."""
        return self.dtype_bytes * (2 * self.b * self.length * self.d
                                   + self.k * self.d)

    def hbm_bytes(self) -> dict:
        """Bytes the kernel's schedule moves to and from device memory:
        every input row once, plus each run's re-read halo; the ``K x D``
        taps once (each warp re-reads its tap rows, a few KB that stay in
        the 50 MB L2); the output once."""
        e = self.dtype_bytes
        inp = e * self.b * self.length * self.d
        halo = e * self.b * self.d * self.halo_rows
        weights = e * self.k * self.d
        out = e * self.b * self.length * self.d
        return dict(input=inp, halo=halo, weights=weights, output=out,
                    total=inp + halo + weights + out)

    def bound(self) -> tuple[float, str]:
        """(ms, "bytes" or "operations"): the least time the H100 takes,
        :attr:`flops` over the peak of the operands' type (67 TFLOP/s f32,
        989 TFLOP/s bf16) against :meth:`min_bytes` over 3.35 TB/s."""
        peak = PEAK_BF16_FLOPS if self.dtype_bytes == 2 else PEAK_F32_FLOPS
        ops_ms = self.flops / peak * 1e3
        bytes_ms = self.min_bytes() / PEAK_BYTES_PER_S * 1e3
        return (max(ops_ms, bytes_ms),
                "operations" if ops_ms >= bytes_ms else "bytes")


@dataclass(frozen=True)
class Conv1dWeightGradPlan:
    """Launch geometry of the conv1d weight-gradient kernel
    (``kernels/csrc/trim_conv1d_wgrad.cu``), which has no Pallas
    counterpart (the JAX package differentiates ``ref.depthwise_conv1d``
    by XLA's autodiff).

        dw[i, d] = sum over (b, t) of x[b, t-K+1+i, d] * dy[b, t, d]

    The (b, t) axis is cut into *runs* of ``tile_l`` steps, each within
    one sequence (its window starts from the ``K-1`` inputs before it,
    zeros before t = 0), numbered b-major; a block takes a *group* of
    :data:`CONV1D_WGRAD_RUNS` consecutive runs (one a warp) over
    ``tile_d`` channels (``vec`` a lane: one 16-byte load a row, 4 f32 or
    8 bf16 channels, where rows are 16-byte aligned; else one), adds its
    warps' sums in run order and writes one f32 ``(K, D)`` partial a
    group into scratch; a second launch adds the partials in group order
    and rounds once to the operands' dtype.  Nothing is summed with
    atomics, so a call is deterministic and its plain version replays it
    bit for bit.

    ``tile_l`` is the longest run of :data:`CONV1D_WGRAD_TILE_LS` that
    still gives :data:`CONV1D_WGRAD_MIN_BLOCKS` blocks, but never one so
    short that its ``K-1`` halo rows exceed
    :data:`CONV1D_WGRAD_HALO_SHARE` of it (32 steps at K = 4): the
    halo is re-read from device memory, the whole cost of a short run,
    while the blocks only need to fill the card once (each thread keeps
    two batches of :data:`CONV1D_WGRAD_UNROLL` rows in flight)."""

    b: int
    length: int
    d: int
    k: int
    tile_l: int
    dtype_bytes: int = 4
    vec: int = 1

    @classmethod
    def build(cls, x_shape, k: int, *, tile_l: int | None = None,
              dtype_bytes: int = 4, vec: int = 1) -> "Conv1dWeightGradPlan":
        """Plan from ``x (B, L, D)``, the tap count ``K``, the element
        size (4: f32, 2: bf16) and the channels a lane (1, or
        ``CONV1D_WGRAD_VEC[dtype_bytes]`` with D a multiple of it),
        choosing ``tile_l`` if it is left as ``None``.  Raises
        ``ValueError`` for what the kernel cannot take.  Cached: the
        wrapper plans on every call."""
        return cls._build(tuple(x_shape), k, tile_l, dtype_bytes, vec)

    @classmethod
    @functools.lru_cache(maxsize=256)
    def _build(cls, x_shape, k, tile_l, dtype_bytes, vec):
        if len(x_shape) != 3:
            raise ValueError(f"x must be (B, L, D); got {tuple(x_shape)}")
        b, length, d = (int(v) for v in x_shape)
        k = int(k)
        if min(b, length, d) < 1:
            raise ValueError(f"empty input {tuple(x_shape)}: B, L and D "
                             "must be >= 1")
        if k < 2:
            raise ValueError(f"K={k}: the kernel takes K >= 2")
        if dtype_bytes not in CONV1D_WGRAD_VEC or vec not in (
                1, CONV1D_WGRAD_VEC[dtype_bytes]) or d % vec:
            raise ValueError(
                f"dtype_bytes={dtype_bytes}, vec={vec}: the kernel takes "
                "f32 (4) with vec 1 or 4 and bf16 (2) with vec 1 or 8, D a "
                "multiple of vec")
        plan = cls(b=b, length=length, d=d, k=k, tile_l=1,
                   dtype_bytes=dtype_bytes, vec=vec)
        if plan.smem_bytes > CONV1D_WGRAD_MAX_SMEM:
            raise ValueError(f"K={k}: the block's sums take "
                             f"{plan.smem_bytes} bytes of shared memory, "
                             f"more than {CONV1D_WGRAD_MAX_SMEM}")
        if tile_l is None:
            fits = [t for t in CONV1D_WGRAD_TILE_LS
                    if k - 1 <= CONV1D_WGRAD_HALO_SHARE * t] \
                or [CONV1D_WGRAD_TILE_LS[0]]
            tile_l = next(
                (t for t in fits
                 if plan.d_tiles * -(-b * -(-length // t)
                                     // CONV1D_WGRAD_RUNS)
                 >= CONV1D_WGRAD_MIN_BLOCKS), fits[-1])
            tile_l = min(tile_l, length)
        if tile_l < 1:
            raise ValueError(f"tile_l={tile_l} must be >= 1")
        return dataclasses.replace(plan, tile_l=tile_l)

    @property
    def tile_d(self) -> int:
        """Channels a block: a warp's lanes times ``vec``."""
        return CONV1D_WGRAD_LANES * self.vec

    @property
    def smem_bytes(self) -> int:
        """The block's shared memory: each warp's K x tile_d f32 sums."""
        return 4 * CONV1D_WGRAD_RUNS * self.k * self.tile_d

    @property
    def runs_per_b(self) -> int:
        return -(-self.length // self.tile_l)

    @property
    def runs(self) -> int:
        return self.b * self.runs_per_b

    @property
    def groups(self) -> int:
        return -(-self.runs // CONV1D_WGRAD_RUNS)

    @property
    def d_tiles(self) -> int:
        return -(-self.d // self.tile_d)

    @property
    def grid(self) -> tuple[int, int]:
        """(groups, channel tiles)."""
        return (self.groups, self.d_tiles)

    @property
    def blocks(self) -> int:
        return self.groups * self.d_tiles

    @property
    def partial_shape(self) -> tuple[int, int, int]:
        """The scratch of the groups' partials, (groups, K, D) f32."""
        return (self.groups, self.k, self.d)

    @property
    def flops(self) -> int:
        return 2 * self.b * self.length * self.d * self.k

    def min_bytes(self) -> int:
        """Bytes the function must move: x and dy read once, dw written
        once, ``dtype_bytes`` an element."""
        return self.dtype_bytes * (2 * self.b * self.length * self.d
                                   + self.k * self.d)

    def hbm_bytes(self) -> dict:
        """Bytes the kernels' schedule moves: x and dy once, each run's
        re-read halo (``min(K-1, t0)`` rows), the f32 partials written and
        read once, dw written."""
        e = self.dtype_bytes
        rows = sum(min(self.k - 1, r * self.tile_l)
                   for r in range(self.runs_per_b))
        inp = 2 * e * self.b * self.length * self.d
        halo = e * self.b * self.d * rows
        partials = 2 * 4 * self.groups * self.k * self.d
        out = e * self.k * self.d
        return dict(input=inp, halo=halo, partials=partials, output=out,
                    total=inp + halo + partials + out)

    def bound(self) -> tuple[float, str]:
        """(ms, "bytes" or "operations"): the least time the H100 takes,
        :attr:`flops` over the peak of the operands' type (67 TFLOP/s f32,
        989 TFLOP/s bf16) against :meth:`min_bytes` over 3.35 TB/s."""
        peak = PEAK_BF16_FLOPS if self.dtype_bytes == 2 else PEAK_F32_FLOPS
        ops_ms = self.flops / peak * 1e3
        bytes_ms = self.min_bytes() / PEAK_BYTES_PER_S * 1e3
        return (max(ops_ms, bytes_ms),
                "operations" if ops_ms >= bytes_ms else "bytes")
