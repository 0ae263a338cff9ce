"""Residency-group fusion planning for the H100 (the counterpart of
``repro/core/fuse_plan.py``; DESIGN.md §8).

A *residency group* is a chain conv→[pool]→conv… that one launch of the
fused kernel (``kernels/csrc/trim_conv2d_fused.cu``) executes with every
interior activation kept in shared memory.  :class:`FusedGroupPlan`
partitions a topology into such groups by a shortest-path dynamic
program over executed device-memory bytes; groups of depth 1 run the
per-layer path, so ``max_depth=1`` is exactly per-layer execution.

What is carried over from the JAX plan, in meaning: the 'same' pads,
:class:`FusedStage`, the per-layer problems, the affine backward
recursion of the strip geometry (:func:`_strip_geometry`),
:class:`FusedGroup`, :func:`build_group`, the layer eligibility rule
and the strip candidates.  With ``band_cols`` at the full width a
group's row geometry is the JAX one.

What is new for Hopper:

* **Tiles cut in both directions.**  The TPU strip spans the full width
  and its working set is sized for 16 MiB of VMEM; a Hopper block has
  :data:`SMEM_PER_BLOCK` (227 KB).  One pooled row of VGG-16's
  conv1→conv2 at full width already needs 229 KB of conv1 output, so a
  tile here is ``strip_rows`` x ``band_cols`` pooled outputs of the last
  stage, and the same recursion runs on the W axis (``*_col_start``,
  ``*_col_step``, ``*_cols``).  A stage's halo grows in both directions
  and its halo columns are computed twice (the executed FLOPs count
  them).
* **Feasibility is the kernel's real footprint** (:attr:`FusedGroup.
  smem_bytes`): two ping-pong buffers, one holding every even stage's
  input tile and one every odd stage's (the stage's pooled output is the
  next stage's input), each at its stage's channel pitch
  (:attr:`FusedStage.cin_pitch`), plus the 2-stage weight ring.
* **The kernel's schedule is planned here.**  A thread holds
  :data:`FUSED_POSITIONS` conv outputs (whole pool windows, so the pool
  runs in registers; a 3x3 window takes :data:`FUSED_POOL3_POSITIONS`) x
  :data:`FUSED_COUT` channels; :attr:`FusedStage.tile_cout` is the C_out
  tile of each stage's fewest *pass tiles* (one sweep of the block's
  accumulators each), then fewest passes.
* **Bytes are the kernel's schedule.**  A fused group reads its stage-0
  windows (halo overlap billed in full), streams each stage's weights
  once per *pass* (all C_out tiles together) and writes the last
  stage's pooled output.  The per-layer baseline is the port's own
  :meth:`ConvPlan.hbm_bytes` schedule plus the separate pool's read and
  write.  The TPU's ``NetworkPlan`` residency decision (VMEM accounting)
  is not ported; a range may fuse when every layer is eligible and some
  tile fits.

The kernel runs f32 or bf16 on the same tile geometry in elements; a
group's element size is its class's ``dtype_bytes`` (:data:`F32_BYTES`
for :class:`FusedGroup`, 2 for :class:`BF16FusedGroup`, which
:meth:`FusedGroupPlan.build` and :func:`build_group` make at
``dtype_bytes=2``), and each stage's schedule is its
:class:`StageLayout` (:attr:`FusedGroup.layouts`): the f32 figures for f32
and for a bf16 stage on the fmaf chain (its bytes halve), its own pitch,
warps, passes and weight ring for a bf16 stage on the bf16 tensor cores
(:func:`stage_layout`, Cin a multiple of 16).  The budget is always
:data:`SMEM_PER_BLOCK`.

DAG topologies (ResNet-18, U-Net): :func:`graph_segments` cuts a graph
into its fusable linear runs between joins, exactly as the JAX function
does, and :class:`GraphFusePlan` plans each run as a chain with its own
:class:`FusedGroupPlan`.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import ClassVar

from repro_torch.core.conv_plan import (BF16_MMA_ROW_PAD, BF16_MMA_WARP_N,
                                        BF16_MMA_WARPS, DTYPE_BYTES,
                                        SMEM_PER_BLOCK, WARP, ConvPlan,
                                        bf16_route, same_pads)
from repro_torch.core.netplan import (graph_nodes, infer_pools,
                                      layer_kernel_problem, network_layers,
                                      pool_between, pooled_out_size)

# Kernel constants, mirroring the constexprs of trim_conv2d_fused.cu (its
# kMaxSmemBytes is conv_plan's SMEM_PER_BLOCK; tests/test_torch_fused.py
# parses the .cu and holds each against its mirror).
MAX_FUSED_K = 8               # taps per side inside a group (ops.MAX_NATIVE_K)
MAX_FUSED_STAGES = 8          # kMaxStages: stages of one launch
FUSED_THREADS = 256           # kThreads: threads per block
FUSED_POSITIONS = 8           # kPositions: conv outputs a thread (pool
                              # window 1 or 2: 8 positions or two windows)
FUSED_POOL3_POSITIONS = 9     # kPool3Positions: ... one 3x3 pool window
FUSED_COUT = 4                # kCout: output channels a thread (a float4)
FUSED_MAX_TILE_COUT = WARP * FUSED_COUT   # kMaxTileCout: a warp along C_out
FUSED_WEIGHT_CHUNK = 32       # kChunk: weight rows (tap, channel) a ring stage
FUSED_WEIGHT_STAGES = 2       # kStages: the weight ring's stages
# A bf16 stage on route mma (bf16_route; the k-order of csrc/bf16_mma.cuh):
# 8 warps of warps_m x warps_n, each with FUSED_MMA_M_FRAGS m16 x 4 n8
# fragments (kBf16FusedMFrags of bf16_mma.cuh), a thread's 2 x that many
# fragment rows holding whole pool windows
FUSED_MMA_M_FRAGS = 4
FUSED_MMA_SLOTS = 2 * FUSED_MMA_M_FRAGS   # a thread's rows: (fragment, g / g+8)
FUSED_MMA_CHUNK = 64          # kBf16FusedChunk: (tap, channel) rows of ...
FUSED_MMA_RING_SLOTS = 2      # kBf16FusedRingSlots: ... its weight ring's
                              # slots
F32_BYTES = 4


# ---------------------------------------------------------------------------
# Static per-stage description + tile geometry
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FusedStage:
    """One conv[+pool] stage of a fused group, with its tile geometry.

    Every range is affine in the tile's strip index ``g`` (rows) and band
    index ``b`` (columns): a tile covers rows ``[start + g*step, start +
    g*step + rows)`` and columns ``[col_start + b*col_step, ... + cols)``
    in the *global* (unpadded) coordinates of that tensor.  ``in_*``
    address the stage's input (the previous stage's pooled output),
    ``conv_*`` the conv output and ``pool_*`` the pooled output.  Rows
    and columns outside the valid extent are zeros — the kernel's mask
    makes them so — and serve as the next stage's 'same' padding.
    """

    name: str
    # problem geometry (square spatial dims)
    h_in: int
    w_in: int
    cin: int
    cout: int
    kernel: int
    stride: int
    pad_lo: int          # 'same' H/W pad (asymmetric), 0 for 'valid'
    pad_hi: int
    h_conv: int          # valid conv output rows (== layer.out_size)
    w_conv: int
    pool_stride: int     # (1, 1) == no pooling
    pool_window: int
    h_pool: int
    w_pool: int
    # row geometry (affine in the strip index g), as the JAX plan's
    in_start: int
    in_step: int
    in_rows: int
    conv_start: int
    conv_step: int
    conv_rows: int
    pool_start: int
    pool_step: int
    pool_rows: int
    # column geometry (affine in the band index b)
    in_col_start: int
    in_col_step: int
    in_cols: int
    conv_col_start: int
    conv_col_step: int
    conv_cols: int
    pool_col_start: int
    pool_col_step: int
    pool_cols: int

    @property
    def weight_shape(self) -> tuple[int, int, int, int]:
        return (self.kernel, self.kernel, self.cin, self.cout)

    @property
    def signature(self) -> str:
        """The stage's problem for the ``conv2d_fused:`` autotune key
        (``repro/core/fuse_plan.py:152``, with the width)."""
        return (f"h{self.h_in}w{self.w_in}c{self.cin}f{self.cout}"
                f"k{self.kernel}s{self.stride}p{self.pad_lo}.{self.pad_hi}"
                f"q{self.pool_stride}x{self.pool_window}")

    @property
    def weight_bytes(self) -> int:
        """Bytes of the stage's weights in f32."""
        k = self.kernel
        return k * k * self.cin * self.cout * F32_BYTES

    @property
    def padding(self) -> str:
        """The ``ops.conv2d`` padding mode of the stage's layer."""
        return "same" if self.pad_lo or self.pad_hi else "valid"

    @property
    def pooled(self) -> bool:
        return self.pool_stride > 1 or self.pool_window > 1

    # -- the kernel's thread layout for this stage ---------------------------

    @property
    def cin_pitch(self) -> int:
        """Channel pitch of the stage's input tile in shared memory:
        ``cin + 4`` where ``cin % 4 == 0`` (4-element loads, a float4 or
        8 bytes of bf16; the positions a warp reads at once fall on
        different banks), else ``cin``."""
        return self.cin + 4 if self.cin % 4 == 0 else self.cin

    @property
    def per_thread(self) -> int:
        """Pooled positions a thread holds in one pass: whole pool
        windows of its :data:`FUSED_POSITIONS` (or, for a 3x3 window,
        :data:`FUSED_POOL3_POSITIONS`) conv accumulators, so the pool
        runs in registers.  0: the kernel takes no such window."""
        slots = (FUSED_POOL3_POSITIONS if self.pool_window == 3
                 else FUSED_POSITIONS)
        return slots // self.pool_window ** 2

    def _pass_tiles(self, tile_cout: int) -> tuple[int, int]:
        """(C_out tiles, passes over the tile's pooled positions) of one
        C_out tile width."""
        threads = -(-tile_cout // FUSED_COUT)
        per_pass = FUSED_THREADS // threads * self.per_thread
        return (-(-self.cout // tile_cout),
                -(-self.pool_rows * self.pool_cols // per_pass))

    @property
    def tile_cout(self) -> int:
        """Output channels of one pass: of 128 (a warp along C_out), 64
        and 32, each capped at C_out, the one with the fewest pass tiles
        (C_out tiles x passes: each a full sweep of the block's 8,192
        accumulators), then the fewest passes (each streams the
        stage's weights once)."""
        cands = sorted({min(self.cout, t) for t in (
            FUSED_MAX_TILE_COUT, FUSED_MAX_TILE_COUT // 2,
            FUSED_MAX_TILE_COUT // 4)}, reverse=True)
        if not self.per_thread:
            return cands[0]

        def key(t):
            co_tiles, passes = self._pass_tiles(t)
            return co_tiles * passes, passes
        return min(cands, key=key)

    @property
    def threads_cout(self) -> int:
        """Threads along C_out, :data:`FUSED_COUT` channels each."""
        return -(-self.tile_cout // FUSED_COUT)

    @property
    def positions_per_pass(self) -> int:
        return FUSED_THREADS // self.threads_cout * self.per_thread

    @property
    def passes(self) -> int:
        """Passes over one tile, all C_out tiles together: each streams
        this stage's weights once."""
        return self._pass_tiles(self.tile_cout)[1]

    @property
    def in_tile_elems(self) -> int:
        """Elements of the stage's input tile at its channel pitch,
        rounded to 4 (a float4 in f32, 8 bytes in bf16)."""
        return -(-self.in_rows * self.in_cols * self.cin_pitch // 4) * 4

    @property
    def tile_macs(self) -> int:
        """MACs of one tile, recomputed halo and masked positions
        included (an overlapping pool recomputes its shared conv
        outputs)."""
        return (self.pool_rows * self.pool_cols * self.pool_window ** 2
                * self.kernel ** 2 * self.cin * self.cout)


@dataclass(frozen=True)
class StageLayout:
    """How the fused kernel runs one stage at one element size: the
    stage's route and the figures of its schedule.  The f32 kernel (and a
    bf16 stage on route ``"ffma"``) takes :class:`FusedStage`'s own
    (``cin_pitch``, ``tile_cout``, ...); a bf16 stage on route ``"mma"``
    its own pitch and warps (:func:`stage_layout`)."""

    route: str              # "ffma" (the fmaf chain) or "mma"
    pitch: int              # channel pitch of the stage's input tile
    tile_cout: int          # output channels of one pass
    per_thread: int         # pooled positions a thread holds in a pass
                            # (mma: whole windows of its fragment rows);
                            # 0: the kernel takes no such pool window
    positions_per_pass: int
    passes: int             # passes over one tile: each streams the
                            # stage's weights once
    ring_row: int           # elements of one weight-ring row it uses
    in_tile_elems: int      # elements of its input tile (buffer sizing)


def _mma_warps_n(tile_cout: int) -> int:
    """Warps along C_out of a route-mma stage: 1, 2 or 4, the fewest whose
    32 channels each hold the tile."""
    return next(w for w in (1, 2, 4) if tile_cout <= w * BF16_MMA_WARP_N)


def _mma_pass_tiles(st: FusedStage, tile_cout: int, wins: int) -> tuple:
    """(C_out tiles, pooled positions a pass, passes) of a route-mma stage
    at one C_out tile: 8 warps of warps_m x warps_n, each warp 8 threads
    groups x ``wins`` windows."""
    warps_n = _mma_warps_n(tile_cout)
    per_pass = BF16_MMA_WARPS // warps_n * 8 * wins
    return (-(-st.cout // tile_cout), per_pass,
            -(-st.pool_rows * st.pool_cols // per_pass))


def stage_layout(st: FusedStage, dtype_bytes: int) -> StageLayout:
    """The fused kernel's layout of ``st`` at ``dtype_bytes``.  f32, and
    bf16 stages whose Cin is not a multiple of 16: the fmaf chain's
    (:class:`FusedStage`'s figures).  bf16 route ``"mma"``: a pitch of
    ``Cin + 8`` (16-byte rows for ``ldmatrix``, an odd count of 16-byte
    quads), whole pool windows in a thread's :data:`FUSED_MMA_SLOTS`
    fragment rows (none for a 3 x 3 window: such a stage does not fuse),
    the C_out tile of 128, 64 or 32 with the fewest pass tiles, then the
    fewest passes, as the fmaf chain chooses; a weight-ring row of the
    tile's warps' channels + 8; its input tile rounded to 8 elements (16
    bytes: a group with such a stage rounds both buffers so, and every
    region of shared memory starts aligned for ``ldmatrix``)."""
    if dtype_bytes == F32_BYTES or bf16_route(st.cin) == "ffma":
        return StageLayout(route="ffma", pitch=st.cin_pitch,
                           tile_cout=st.tile_cout, per_thread=st.per_thread,
                           positions_per_pass=st.positions_per_pass,
                           # no passes where the kernel takes no window
                           passes=st.passes if st.per_thread else 0,
                           ring_row=FUSED_COUT * st.threads_cout,
                           in_tile_elems=st.in_tile_elems)
    pitch = st.cin + BF16_MMA_ROW_PAD
    wins = FUSED_MMA_SLOTS // st.pool_window ** 2
    cands = sorted({min(st.cout, t) for t in (
        FUSED_MAX_TILE_COUT, FUSED_MAX_TILE_COUT // 2,
        FUSED_MAX_TILE_COUT // 4)}, reverse=True)
    tile, per_pass, passes = cands[0], 0, 0
    if wins:
        def key(t):
            co_tiles, _, passes = _mma_pass_tiles(st, t, wins)
            return co_tiles * passes, passes
        tile = min(cands, key=key)
        _, per_pass, passes = _mma_pass_tiles(st, tile, wins)
    return StageLayout(route="mma", pitch=pitch, tile_cout=tile,
                       per_thread=wins, positions_per_pass=per_pass,
                       passes=passes,
                       ring_row=BF16_MMA_WARP_N * _mma_warps_n(tile)
                       + BF16_MMA_ROW_PAD,
                       in_tile_elems=-(-st.in_rows * st.in_cols * pitch
                                       // 8) * 8)


def _stage_problems(layers, pools):
    """Per-layer (layer, pad_lo, pad_hi, h_conv, ps, pw, h_pool) tuples,
    validating each layer is 'same'/'valid'-executable."""
    probs = []
    for layer, (ps, pw) in zip(layers, pools):
        layer_kernel_problem(layer)     # raises if not 'same'/'valid'
        lo, hi = (same_pads(layer.ifmap, layer.kernel, layer.stride)
                  if layer.padding else (0, 0))
        h_conv = layer.out_size
        probs.append((layer, lo, hi, h_conv, ps, pw,
                      pooled_out_size(h_conv, ps, pw)))
    return probs


def _backward_ranges(probs, tile):
    """The affine backward recursion on one axis: from ``tile`` pooled
    outputs of the last stage, each stage's (input, conv, pool) ranges
    as ``(start, step, size)`` triples, first stage first.

    A pooled range needs conv positions ``[a*ps, a*ps + (c-1)*ps + pw)``;
    a conv range needs padded-input positions ``[a*s, a*s + (c-1)*s +
    K)``; un-padding subtracts the leading 'same' pad."""
    out = []
    a, b, c = 0, tile, tile
    for layer, lo, _hi, _h_conv, ps, pw, _h_pool in reversed(probs):
        pool = (a, b, c)
        a, b, c = a * ps, b * ps, (c - 1) * ps + pw
        conv = (a, b, c)
        s, k = layer.stride, layer.kernel
        a, b, c = a * s - lo, b * s, (c - 1) * s + k
        out.append(((a, b, c), conv, pool))
    out.reverse()
    return out


def _strip_geometry(probs, strip_rows, band_cols=None):
    """Every stage's row and column ranges for a tile of ``strip_rows`` x
    ``band_cols`` pooled outputs of the last stage (``band_cols`` None:
    the full width).  The stage-0 input ranges are what one block
    reads from device memory."""
    if band_cols is None:
        band_cols = probs[-1][6]
    rows = _backward_ranges(probs, strip_rows)
    cols = _backward_ranges(probs, band_cols)
    stages = []
    for (layer, lo, hi, h_conv, ps, pw, h_pool), r, c in zip(probs, rows,
                                                             cols):
        stages.append(FusedStage(
            name=layer.name, h_in=layer.ifmap, w_in=layer.ifmap,
            cin=layer.in_channels, cout=layer.out_channels,
            kernel=layer.kernel, stride=layer.stride, pad_lo=lo, pad_hi=hi,
            h_conv=h_conv, w_conv=h_conv,
            pool_stride=ps, pool_window=pw, h_pool=h_pool, w_pool=h_pool,
            in_start=r[0][0], in_step=r[0][1], in_rows=r[0][2],
            conv_start=r[1][0], conv_step=r[1][1], conv_rows=r[1][2],
            pool_start=r[2][0], pool_step=r[2][1], pool_rows=r[2][2],
            in_col_start=c[0][0], in_col_step=c[0][1], in_cols=c[0][2],
            conv_col_start=c[1][0], conv_col_step=c[1][1],
            conv_cols=c[1][2],
            pool_col_start=c[2][0], pool_col_step=c[2][1],
            pool_cols=c[2][2]))
    return tuple(stages)


# ---------------------------------------------------------------------------
# A fused residency group
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FusedGroup:
    """One residency group: ``depth`` consecutive layers executed as one
    launch of the fused kernel (depth >= 2) or by the per-layer path
    (depth 1, where the tile geometry is unused), planned for f32."""

    start: int                          # index of the first layer
    stages: tuple[FusedStage, ...]
    n: int = 1
    strip_rows: int = 1                 # pooled rows of the LAST stage/tile
    band_cols: int = 1                  # pooled columns of the LAST stage/tile
    # bytes of one element: a class attribute, not a field, so that a
    # group's fields (the geometry, in elements) are the same in f32 and
    # bf16 and only the byte counts below differ
    dtype_bytes: ClassVar[int] = F32_BYTES

    @property
    def depth(self) -> int:
        return len(self.stages)

    @property
    def fused(self) -> bool:
        return self.depth >= 2

    @property
    def last(self) -> FusedStage:
        return self.stages[-1]

    @property
    def n_strips(self) -> int:
        return math.ceil(self.last.h_pool / self.strip_rows)

    @property
    def n_bands(self) -> int:
        return math.ceil(self.last.w_pool / self.band_cols)

    @property
    def n_tiles(self) -> int:
        """Blocks of one launch: (image, strip, band)."""
        return self.n * self.n_strips * self.n_bands

    @property
    def out_shape(self) -> tuple[int, int, int, int]:
        lt = self.last
        return (self.n, lt.h_pool, lt.w_pool, lt.cout)

    @property
    def label(self) -> str:
        return (self.stages[0].name if self.depth == 1 else
                f"{self.stages[0].name}..{self.last.name}")

    @property
    def signature(self) -> str:
        """The per-stage signature chain keying the group's
        ``conv2d_fused:`` record (independent of the tile)."""
        return "-".join(st.signature for st in self.stages)

    # -- shared memory -------------------------------------------------------

    @functools.cached_property
    def layouts(self) -> tuple[StageLayout, ...]:
        """Each stage's :class:`StageLayout` at the group's element size
        (f32: :class:`FusedStage`'s own figures)."""
        return tuple(stage_layout(st, self.dtype_bytes)
                     for st in self.stages)

    @property
    def buffer_elems(self) -> tuple[int, int]:
        """Elements of the two ping-pong buffers: stage i's input tile
        lives in buffer ``i % 2`` (stage i writes its pooled, masked
        output — stage i+1's input — into the other)."""
        bufs = [0, 0]
        for i, lay in enumerate(self.layouts):
            bufs[i % 2] = max(bufs[i % 2], lay.in_tile_elems)
        if any(lay.route == "mma" for lay in self.layouts):
            return tuple(-(-b // 8) * 8 for b in bufs)   # 16-byte aligned
        return bufs[0], bufs[1]

    @property
    def ring_cout(self) -> int:
        """Elements of one weight-ring row: the widest stage's C_out tile
        rounded up to whole threads (bf16 route mma: its warps' channels
        + 8)."""
        return max(lay.ring_row for lay in self.layouts)

    @property
    def ring_elems(self) -> int:
        """Elements of the weight ring: :data:`FUSED_WEIGHT_STAGES` slots
        of :data:`FUSED_WEIGHT_CHUNK` rows of :attr:`ring_cout`, or a bf16
        route-mma stage's :data:`FUSED_MMA_RING_SLOTS` slots of
        :data:`FUSED_MMA_CHUNK` rows of its own, the larger."""
        return max(lay.ring_row * (
            FUSED_MMA_RING_SLOTS * FUSED_MMA_CHUNK if lay.route == "mma"
            else FUSED_WEIGHT_STAGES * FUSED_WEIGHT_CHUNK)
            for lay in self.layouts)

    @property
    def smem_bytes(self) -> int:
        """Everything the kernel allocates in shared memory: both
        buffers and the weight ring."""
        return self.dtype_bytes * (sum(self.buffer_elems) + self.ring_elems)

    # -- arithmetic / traffic ------------------------------------------------

    @property
    def macs(self) -> int:
        """Useful MACs: each valid conv output once."""
        return sum(self.n * st.h_conv * st.w_conv * st.cout
                   * st.kernel * st.kernel * st.cin for st in self.stages)

    @property
    def flops(self) -> int:
        return 2 * self.macs

    @property
    def executed_flops(self) -> int:
        """FLOPs the kernel executes: every tile computes its whole
        halo (twice-computed rows and columns, masked positions, an
        overlapping pool's shared conv outputs)."""
        return 2 * self.n_tiles * sum(st.tile_macs for st in self.stages)

    @property
    def recompute(self) -> float:
        return self.executed_flops / self.flops

    def hbm_bytes(self) -> dict:
        """Device-memory bytes of the kernel's schedule: each tile's
        stage-0 window (halo overlap billed in full), each stage's
        weights once per pass, one write of the pooled output.  Interior
        activations and pools move nothing."""
        lt, db, lays = self.last, self.dtype_bytes, self.layouts
        in_bytes = self.n_tiles * lays[0].in_tile_elems * db
        w_bytes = self.n_tiles * db * sum(
            lay.passes * math.prod(st.weight_shape)
            for st, lay in zip(self.stages, lays))
        out_bytes = self.n * lt.h_pool * lt.w_pool * lt.cout * db
        return dict(input=in_bytes, weights=w_bytes, output=out_bytes,
                    total=in_bytes + w_bytes + out_bytes)

    def min_bytes(self) -> int:
        """The least bytes the group's function must move: the input,
        each weight and bias once, the output once."""
        s0, lt = self.stages[0], self.last
        elems = (self.n * s0.h_in * s0.w_in * s0.cin
                 + sum(st.kernel ** 2 * st.cin * st.cout + st.cout
                       for st in self.stages)
                 + self.n * lt.h_pool * lt.w_pool * lt.cout)
        return self.dtype_bytes * elems


class BF16FusedGroup(FusedGroup):
    """A :class:`FusedGroup` planned for the bf16 instance of the fused
    kernel (``trim_conv2d_fused_bf16``): the same tile geometry in
    elements, two bytes each; a stage whose Cin is a multiple of 16 runs
    on the bf16 tensor cores (:func:`stage_layout`: its own pitch, warps
    and passes), the rest take the fmaf chain."""

    dtype_bytes = 2


_GROUP_TYPES = {F32_BYTES: FusedGroup, 2: BF16FusedGroup}


def build_group(layers, start, *, n=1, strip_rows=1, band_cols=None,
                pools=None, dtype_bytes: int = F32_BYTES):
    """A :class:`FusedGroup` (a :class:`BF16FusedGroup` at ``dtype_bytes``
    2) over ``layers``; ``band_cols`` None is the full width of the last
    stage's pooled output.  ``pools`` defaults to :func:`infer_pools`
    over ``layers`` *as given* (pass the whole-network pools to keep a
    trailing group's final pool)."""
    if dtype_bytes not in _GROUP_TYPES:
        raise ValueError(f"dtype_bytes={dtype_bytes}: the fused kernel "
                         f"takes {sorted(_GROUP_TYPES)} (bf16, f32)")
    if pools is None:
        pools = infer_pools(list(layers))
    probs = _stage_problems(list(layers), list(pools))
    if band_cols is None:
        band_cols = probs[-1][6]
    stages = _strip_geometry(probs, strip_rows, band_cols)
    return _GROUP_TYPES[dtype_bytes](start=start, stages=stages, n=n,
                                     strip_rows=strip_rows,
                                     band_cols=band_cols)


# ---------------------------------------------------------------------------
# Whole-network partition
# ---------------------------------------------------------------------------

def _layer_eligible(layer) -> bool:
    """Can this layer run *inside* a fused group at all?"""
    if layer.groups != 1 or layer.kernel > MAX_FUSED_K:
        return False
    if layer.stride > 1 and layer.out_size == 1:
        # the JAX plan's rule: a strided stage collapsing to one output
        # row gains nothing from a tile and broke bit-equality there
        return False
    try:
        layer_kernel_problem(layer)
    except ValueError:
        return False
    return True


def _strip_candidates(h_pool_last: int):
    """Candidate tile sides: powers of two up to the full pooled extent
    (the full extent is always included)."""
    t, cands = 1, []
    while t < h_pool_last:
        cands.append(t)
        t *= 2
    cands.append(h_pool_last)
    return cands


def _tile_candidates(layers, start, *, n, pools,
                     dtype_bytes: int = F32_BYTES):
    """Every tile of the group over ``layers`` (``strip_rows`` x
    ``band_cols`` over :func:`_strip_candidates`, strips outer) whose
    shared memory fits :data:`SMEM_PER_BLOCK` at ``dtype_bytes``; none
    when the kernel takes no stage's pool window."""
    probe = build_group(layers, start, n=n, pools=pools,
                        dtype_bytes=dtype_bytes)
    if not all(lay.per_thread for lay in probe.layouts):
        return []
    out = []
    for t in _strip_candidates(probe.last.h_pool):
        for b in _strip_candidates(probe.last.w_pool):
            g = build_group(layers, start, n=n, strip_rows=t, band_cols=b,
                            pools=pools, dtype_bytes=dtype_bytes)
            if g.smem_bytes <= SMEM_PER_BLOCK:
                out.append(g)
    return out


@functools.lru_cache(maxsize=256)
def _group_at(layers, start, depth, n, strip_rows, band_cols,
              dtype_bytes=F32_BYTES):
    """The group over ``layers[start:start+depth]`` (whole-network pools)
    at one tile."""
    pools = infer_pools(list(layers))[start:start + depth]
    return build_group(layers[start:start + depth], start, n=n,
                       strip_rows=strip_rows, band_cols=band_cols,
                       pools=pools, dtype_bytes=dtype_bytes)


def per_layer_exec_bytes(layers, pools, *, n,
                         dtype_bytes: int = F32_BYTES) -> tuple:
    """What the port's per-layer path moves for each layer: the carry
    kernel's schedule (:meth:`ConvPlan.hbm_bytes`, at ``dtype_bytes``)
    with the full ofmap written, plus the separate pool's read of that
    ofmap and write of the pooled result (``pool``)."""
    out = []
    for layer, (ps, pw) in zip(layers, pools):
        x_shape = (n, layer.ifmap, layer.ifmap, layer.in_channels)
        w_shape = (layer.kernel, layer.kernel,
                   layer.in_channels // layer.groups, layer.out_channels)
        pads = ((same_pads(layer.ifmap, layer.kernel, layer.stride),) * 2
                if layer.padding else 0)
        b = dict(ConvPlan.build(x_shape, w_shape, stride=layer.stride,
                                pad=pads, groups=layer.groups,
                                dtype_bytes=dtype_bytes).hbm_bytes())
        b["pool"] = 0
        if ps > 1 or pw > 1:
            h = layer.out_size
            b["pool"] = n * layer.out_channels * dtype_bytes * (
                h * h + pooled_out_size(h, ps, pw) ** 2)
        b["total"] += b["pool"]
        out.append(b)
    return tuple(out)


@dataclass(frozen=True)
class FusedGroupPlan:
    """Partition of a network into residency groups, with executed-byte
    accounting for the fused schedule against the per-layer one."""

    groups: tuple[FusedGroup, ...]
    n: int
    layer_exec_bytes: tuple   # per-layer executed byte dicts
    dtype_bytes: int = F32_BYTES   # 4: f32 groups; 2: BF16FusedGroup

    @classmethod
    def build(cls, network, *, n: int = 1, max_depth: int | None = None,
              use_autotune_cache: bool = False, device=None,
              dtype_bytes: int = F32_BYTES) -> "FusedGroupPlan":
        """Partition ``network`` (name or layer list) into residency
        groups, with the fewest executed device-memory bytes.

        A range of two or more layers may form one fused group iff every
        layer is eligible (:func:`_layer_eligible`), it has at most
        :data:`MAX_FUSED_STAGES` layers, and some tile keeps the
        kernel's shared memory within :data:`SMEM_PER_BLOCK`.
        ``max_depth`` caps the depth (``max_depth=1`` is per-layer
        execution).  Plans are cached by their arguments.

        The partition is model-driven and reads no cache.  With
        ``use_autotune_cache=True`` each fused group then takes the tile
        of its ``conv2d_fused:`` record for ``device``'s backend
        (``core.autotune.fused_knobs_for``; ``device`` None is
        ``"cuda"``), where one exists and fits; a record whose tile does
        not fit is a miss with one warning.

        ``dtype_bytes=2`` plans the bf16 kernel: :class:`BF16FusedGroup`
        tiles sized for bf16 shared memory, bytes (the per-layer
        baseline's too) at two an element, and the ``bfloat16`` records.
        """
        layers = tuple(network_layers(network))
        plan = _build_plan(layers, n, max_depth, dtype_bytes)
        if not use_autotune_cache:
            return plan
        from repro_torch.core import autotune
        dtype = DTYPE_BYTES[dtype_bytes]
        groups = []
        for g in plan.groups:
            rec = autotune.fused_knobs_for(g.signature, n=n, dtype=dtype,
                                           device=device) \
                if g.fused else None
            routes = [lay.route for lay in g.layouts]
            if rec is not None and dtype_bytes == 2 and rec.get(
                    "routes", ["ffma"] * g.depth) != routes:
                # a record of the fmaf-chain design, or of other routes
                autotune._reject(
                    autotune.fused_key(g.signature, n=n, dtype=dtype,
                                       device=device),
                    f"a record of bf16 routes {rec.get('routes')} for a "
                    f"group on {routes}", None)
                rec = None
            if rec is not None and (rec["strip_rows"], rec["band_cols"]) \
                    != (g.strip_rows, g.band_cols):
                t = _group_at(layers, g.start, g.depth, n, rec["strip_rows"],
                              rec["band_cols"], dtype_bytes)
                if t.smem_bytes <= SMEM_PER_BLOCK \
                        and t.strip_rows <= g.last.h_pool \
                        and t.band_cols <= g.last.w_pool:
                    g = t
                else:
                    autotune._reject(
                        autotune.fused_key(g.signature, n=n, dtype=dtype,
                                           device=device),
                        f"tile {t.strip_rows} x {t.band_cols} does not fit "
                        f"({t.smem_bytes} B of shared memory, pooled output "
                        f"{g.last.h_pool} x {g.last.w_pool})", None)
            groups.append(g)
        return dataclasses.replace(plan, groups=tuple(groups))

    @staticmethod
    def _tune_group(layers, pools, start, depth, *, n,
                    dtype_bytes: int = F32_BYTES):
        """The tile of least executed bytes (then least executed FLOPs)
        over ``layers[start:start+depth]`` whose shared memory fits
        :data:`SMEM_PER_BLOCK` (:func:`_tile_candidates`), or None when
        none fits or the kernel takes no stage's pool window."""
        cands = _tile_candidates(layers[start:start + depth], start, n=n,
                                 pools=pools[start:start + depth],
                                 dtype_bytes=dtype_bytes)
        if not cands:
            return None
        return min(cands, key=lambda g: (g.hbm_bytes()["total"],
                                         g.executed_flops))

    # -- accounting ----------------------------------------------------------

    @property
    def depth(self) -> int:
        return max(g.depth for g in self.groups)

    @property
    def fused_groups(self) -> tuple[FusedGroup, ...]:
        return tuple(g for g in self.groups if g.fused)

    @property
    def flops(self) -> int:
        return sum(g.flops for g in self.groups)

    @property
    def executed_flops(self) -> int:
        """Fused groups' executed FLOPs (recomputed halo included) plus
        the per-layer FLOPs of depth-1 groups."""
        return sum(g.executed_flops if g.fused else g.flops
                   for g in self.groups)

    def executed_hbm_bytes(self) -> dict:
        """Bytes the fused execution moves: the fused kernel's schedule
        for fused groups, the per-layer schedule (separate pool
        included) for depth-1 groups."""
        tot = dict(input=0, weights=0, output=0, pool=0, total=0)
        for g in self.groups:
            b = g.hbm_bytes() if g.fused else self.layer_exec_bytes[g.start]
            for k in tot:
                tot[k] += b.get(k, 0)
        return tot

    def never_hbm_bytes(self) -> int:
        """The per-layer baseline: every boundary through device memory,
        every pool a separate read and write."""
        return sum(b["total"] for b in self.layer_exec_bytes)

    def executed_ratio(self) -> float:
        return self.never_hbm_bytes() \
            / max(self.executed_hbm_bytes()["total"], 1)

    def describe(self) -> str:
        """The groups in order: ``conv1..conv2 (T=8, B=16) | conv3 | …``
        (T, B: the tile's pooled rows and columns of its last stage)."""
        return " | ".join(
            f"{g.label} (T={g.strip_rows}, B={g.band_cols})" if g.fused
            else g.label for g in self.groups)

    def summary(self) -> dict:
        return dict(groups=len(self.groups), max_depth=self.depth,
                    fused_layers=sum(g.depth for g in self.fused_groups),
                    executed_bytes=self.executed_hbm_bytes()["total"],
                    per_layer_bytes=self.never_hbm_bytes(),
                    executed_ratio=self.executed_ratio(),
                    flops=self.flops, executed_flops=self.executed_flops)


@functools.lru_cache(maxsize=64)
def _build_plan(layers, n, max_depth, dtype_bytes=F32_BYTES):
    layers = list(layers)
    pools = list(infer_pools(layers))
    exec_bytes = per_layer_exec_bytes(layers, pools, n=n,
                                      dtype_bytes=dtype_bytes)
    cap = min(len(layers) if max_depth is None else max(1, max_depth),
              MAX_FUSED_STAGES)

    def group_cost(i, j):
        """Best group over layers[i..j] and its bytes, or (None, inf)."""
        if j > i:
            if not all(_layer_eligible(layers[k]) for k in range(i, j + 1)):
                return None, math.inf
            g = FusedGroupPlan._tune_group(layers, pools, i, j - i + 1, n=n,
                                           dtype_bytes=dtype_bytes)
            if g is None:
                return None, math.inf
            return g, g.hbm_bytes()["total"]
        g = build_group(layers[i:i + 1], i, n=n, pools=pools[i:i + 1],
                        dtype_bytes=dtype_bytes)
        return g, exec_bytes[i]["total"]

    # shortest path over layer boundaries: best[j] = least bytes for
    # layers[0..j-1]; the all-singletons path is always legal, so the
    # optimum never exceeds the per-layer baseline.
    best = [0.0] + [math.inf] * len(layers)
    choice: list = [None] * (len(layers) + 1)
    for j in range(1, len(layers) + 1):
        for i in range(max(0, j - cap), j):
            g, cost = group_cost(i, j - 1)
            if g is not None and best[i] + cost < best[j]:
                best[j] = best[i] + cost
                choice[j] = g
    groups: list[FusedGroup] = []
    j = len(layers)
    while j > 0:
        g = choice[j]
        groups.append(g)
        j = g.start
    groups.reverse()
    return FusedGroupPlan(groups=tuple(groups), n=n,
                          layer_exec_bytes=exec_bytes,
                          dtype_bytes=dtype_bytes)


# ---------------------------------------------------------------------------
# DAG segmentation: fusable linear runs between joins
# ---------------------------------------------------------------------------

def graph_segments(nodes) -> list[tuple[tuple[str, ...], tuple]]:
    """Maximal fusable linear runs of a DAG topology
    (``repro/core/fuse_plan.py:596``), as ``(names, layers)`` tuples: the
    covered node names (conv nodes plus absorbed single-consumer pool
    nodes, in topological order) and the run's ``ConvLayer`` chain.

    A run extends from conv to conv only while the intermediate tensor
    has exactly one consumer (joins, skip taps and network outputs end
    runs: their tensor must materialize) and the boundary's pooling is
    exactly re-inferable from the spatial dims by
    :func:`~repro_torch.core.netplan.pool_between`, so each run is a
    linear chain that :class:`FusedGroupPlan` and
    ``cnn_apply_from_layers`` take unchanged.  A trailing conv-node
    epilogue pool is *not* part of the run (the graph executor applies
    it after the run)."""
    nodes = list(nodes)
    by = {nd.name: nd for nd in nodes}
    cons: dict[str, list[str]] = {nd.name: [] for nd in nodes}
    for nd in nodes:
        for s in nd.inputs:
            cons[s].append(nd.name)
    used: set[str] = set()
    segments: list[tuple[tuple[str, ...], tuple]] = []
    for nd in nodes:
        if nd.op != "conv" or nd.name in used:
            continue
        names, layers = [nd.name], [nd.layer]
        used.add(nd.name)
        cur = nd
        while True:
            nxts = cons[cur.name]
            if len(nxts) != 1:
                break
            nxt = by[nxts[0]]
            absorbed: list[str] = []
            if nxt.op == "pool":
                if cur.pool > 1 or cur.pool_window > 1:
                    break        # stacked pools: not dims-recoverable
                pc = cons[nxt.name]
                if len(pc) != 1:
                    break        # pooled tensor has other consumers
                cand = by[pc[0]]
                expected = (nxt.pool, nxt.pool_window)
                absorbed = [nxt.name]
            elif nxt.op == "conv":
                cand = nxt
                expected = (cur.pool, cur.pool_window)
            else:
                break            # add / concat / upsample end the run
            if cand.op != "conv":
                break
            try:
                if pool_between(cur.layer, cand.layer) != expected:
                    break        # dims would re-infer a different pool
            except ValueError:
                break
            names.extend(absorbed)
            names.append(cand.name)
            layers.append(cand.layer)
            used.update(absorbed)
            used.add(cand.name)
            cur = cand
        segments.append((tuple(names), tuple(layers)))
    return segments


@dataclass(frozen=True)
class GraphFusePlan:
    """Fusion partition of a DAG topology (``repro/core/fuse_plan.py:
    663``): each fusable linear segment between joins
    (:func:`graph_segments`) is planned as a chain, with its own
    :class:`FusedGroupPlan`; joins and skip taps stay un-fused, since
    their tensors must materialize.

    Bytes are the port plans' own (:meth:`FusedGroupPlan.
    executed_hbm_bytes`, :meth:`FusedGroupPlan.never_hbm_bytes`), summed
    over the segments; join traffic is the same on both sides of
    :meth:`executed_ratio` and is not counted.  The JAX plan's TPU
    arguments (``residency``, ``residency_budget``, ``vmem_budget``,
    ``strip_rows``, ``dtype_bytes``) are left out, as
    :meth:`FusedGroupPlan.build` leaves them out: the port plans 227 KB
    of shared memory in f32 and picks each group's tile itself."""

    name: str
    segments: tuple              # (names, FusedGroupPlan) pairs
    n: int

    @classmethod
    def build(cls, graph, *, n: int = 1, max_depth: int | None = None,
              use_autotune_cache: bool = False,
              device=None) -> "GraphFusePlan":
        """Plan every segment of ``graph`` (anything
        :func:`~repro_torch.core.netplan.graph_nodes` resolves) at batch
        ``n``; the keywords go to :meth:`FusedGroupPlan.build`."""
        segs = tuple(
            (names, FusedGroupPlan.build(
                list(layers), n=n, max_depth=max_depth,
                use_autotune_cache=use_autotune_cache, device=device))
            for names, layers in graph_segments(graph_nodes(graph)))
        nm = graph if isinstance(graph, str) else "custom"
        return cls(name=nm, segments=segs, n=n)

    @property
    def n_segments(self) -> int:
        return len(self.segments)

    @property
    def groups(self) -> tuple[FusedGroup, ...]:
        return tuple(g for _, p in self.segments for g in p.groups)

    @property
    def flops(self) -> int:
        return sum(p.flops for _, p in self.segments)

    @property
    def macs(self) -> int:
        return sum(g.macs for g in self.groups)

    def executed_hbm_bytes(self) -> dict:
        tot = dict(input=0, weights=0, output=0, pool=0, total=0)
        for _, p in self.segments:
            b = p.executed_hbm_bytes()
            for k in tot:
                tot[k] += b.get(k, 0)
        return tot

    def never_hbm_bytes(self) -> int:
        return sum(p.never_hbm_bytes() for _, p in self.segments)

    def executed_ratio(self) -> float:
        return self.never_hbm_bytes() \
            / max(self.executed_hbm_bytes()["total"], 1)

    def as_rows(self) -> list[dict]:
        """One row a group: its segment, layers, tile and executed
        bytes (the fused schedule's, or the per-layer path's for a
        depth-1 group)."""
        rows = []
        for names, p in self.segments:
            for g in p.groups:
                b = g.hbm_bytes() if g.fused else p.layer_exec_bytes[g.start]
                rows.append(dict(
                    segment=list(names), start=g.start, depth=g.depth,
                    fused=g.fused, layers=[st.name for st in g.stages],
                    strip_rows=g.strip_rows, band_cols=g.band_cols,
                    n_tiles=g.n_tiles, flops=g.flops,
                    hbm_total=b["total"]))
        return rows

    def summary(self) -> dict:
        return dict(segments=self.n_segments,
                    groups=sum(len(p.groups) for _, p in self.segments),
                    max_depth=max(p.depth for _, p in self.segments),
                    fused_layers=sum(g.depth for g in self.groups
                                     if g.fused),
                    executed_bytes=self.executed_hbm_bytes()["total"],
                    per_layer_bytes=self.never_hbm_bytes(),
                    executed_ratio=self.executed_ratio())
