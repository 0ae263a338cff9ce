"""Hopper launch geometry for one 3D-TrIM convolution and its gradients.

:class:`ConvPlan` is the counterpart of ``repro.core.conv_plan.ConvPlan``
for the H100 forward kernels of ``kernels/csrc/trim_conv2d.cu`` (which
also run the input gradient, laid out by :func:`input_grad_geometry`);
:class:`WeightGradPlan` plans the weight-gradient kernel of
``kernels/csrc/trim_conv2d_wgrad.cu``, and :class:`Conv1dPlan` the causal
depthwise conv1d of ``kernels/csrc/trim_conv1d.cu``.  The TPU forward plan
sizes its strips for an 8 MiB VMEM budget and 128-lane C_out tiles;
neither applies to the card, where a block has at most 227 KB of shared
memory.  So a block here owns a *column band* of ``tile_w`` output
columns as well as a C_out tile, and holds the band's input window for
all ``Cin/groups`` channels:

* ``tile_h`` — fresh input rows per strip (a multiple of the stride; the
  strip makes ``tile_h // stride`` output rows).  Oversized strips are
  clamped to the full height, as ``ConvPlan`` clamps them
  (``repro/core/conv_plan.py:166-173``).
* ``carry_rows = max(K - stride, 0)`` — the rows a strip shares with its
  successor: kept in shared memory by ``carry``, re-read by ``halo``.
* ``window_rows x window_cols x Cin/groups`` — the shared-memory ring;
  ``smem_bytes`` adds one staged weight chunk and must fit
  :data:`SMEM_PER_BLOCK`.

The kernel constants (threads, per-thread register tile, weight chunk)
mirror the ``constexpr`` values at the top of the ``.cu`` file.
"""

from __future__ import annotations

from dataclasses import dataclass

SMEM_PER_BLOCK = 232_448     # H100: 227 KB of opt-in shared memory per block
THREADS = 256                # threads per block (kThreads)
MAX_POSITIONS = 8            # output positions per thread (kMaxPositions)
MAX_COUT_PER_THREAD = 4      # output channels per thread (kMaxCout)
WEIGHT_CHUNK = 32            # input channels per staged weight chunk
WARP = 32
DEFAULT_TILE_W = 16          # output columns per band
DEFAULT_TILE_COUT = 64       # output channels per block
DATAFLOWS = ("carry", "halo")


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


@dataclass(frozen=True)
class ConvPlan:
    """Launch geometry of one strided, grouped NHWC conv on the card.

    Input ``(N, H, W, Cin)``, weights ``(K, K, Cin/groups, Cout)``, zero
    padding ``pads = ((top, bottom), (left, right))`` applied virtually by
    the kernel's loader.
    """

    n: int
    h: int
    w: int
    cin: int
    cout: int
    k: int
    stride: int
    pads: tuple
    groups: int
    tile_h: int
    tile_w: int
    tile_cout: int
    dataflow: str = "carry"

    def __post_init__(self):
        if self.dataflow not in DATAFLOWS:
            raise ValueError(f"dataflow={self.dataflow!r} must be one of "
                             f"{DATAFLOWS}")
        if self.tile_h < self.stride or self.tile_h % self.stride:
            raise ValueError(f"tile_h={self.tile_h} must be a positive "
                             f"multiple of the stride {self.stride}")

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, x_shape, w_shape, *, stride: int = 1, pad=0,
              groups: int = 1, tile_h: int | None = None,
              tile_cout: int | None = None, dataflow: str = "carry") -> "ConvPlan":
        """Plan from tensor shapes, choosing any tile left as ``None``.

        ``tile_cout`` defaults to 64 (one warp, two channels a thread) or
        the whole per-group C_out when smaller; above a warp it is rounded
        up to whole warps.  ``tile_w`` is 16 columns (or the output width);
        the strip is the tallest that keeps the block's output positions
        within its threads' registers and its window within
        :data:`SMEM_PER_BLOCK`, narrowing the band when one output row does not
        fit.  Raises ``ValueError`` when no geometry fits, so every plan it
        returns is one the kernel takes.
        """
        n, h, w, cin = x_shape
        kh, kw, cin_pg, cout = w_shape
        if kh != kw:
            raise ValueError(f"square kernels only, got {kh}x{kw}")
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
        cout_pg = cout // groups
        if tile_cout is None:
            tile_cout = min(cout_pg, DEFAULT_TILE_COUT)
        if tile_cout < 1:
            raise ValueError(f"tile_cout={tile_cout} must be >= 1")
        tile_cout = min(tile_cout, cout_pg)
        if tile_cout > WARP:
            tile_cout = -(-tile_cout // WARP) * WARP
        if tile_cout > WARP * MAX_COUT_PER_THREAD:
            raise ValueError(f"tile_cout={tile_cout} exceeds "
                             f"{WARP * MAX_COUT_PER_THREAD}")
        max_positions = THREADS // min(tile_cout, WARP) * MAX_POSITIONS
        for tile_w in range(min(DEFAULT_TILE_W, w_out), 0, -1):
            if tile_h is not None:
                # an oversized strip is clamped to the full height
                heights = [min(tile_h, h_out * stride)]
            else:
                rows = min(h_out, max_positions // tile_w)
                heights = [r * stride for r in range(rows, 0, -1)]
            for th in heights:
                plan = cls(n=n, h=h, w=w, cin=cin, cout=cout, k=kh,
                           stride=stride, pads=pads, groups=groups,
                           tile_h=th, tile_w=tile_w, tile_cout=tile_cout,
                           dataflow=dataflow)
                if (plan.smem_bytes <= SMEM_PER_BLOCK
                        and plan.positions <= max_positions):
                    return plan
        raise ValueError(
            f"no strip of tile_h={tile_h} fits {SMEM_PER_BLOCK} B of shared "
            f"memory at K={kh}, Cin/groups={cin_pg}")

    # -- problem geometry --------------------------------------------------

    @property
    def cin_per_group(self) -> int:
        return self.cin // self.groups

    @property
    def cout_per_group(self) -> int:
        return self.cout // self.groups

    @property
    def h_out(self) -> int:
        return (self.h + sum(self.pads[0]) - self.k) // self.stride + 1

    @property
    def w_out(self) -> int:
        return (self.w + sum(self.pads[1]) - self.k) // self.stride + 1

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
        return max(self.k - self.stride, 0)

    @property
    def window_rows(self) -> int:
        return self.tile_h + self.carry_rows

    @property
    def window_cols(self) -> int:
        return (self.tile_w - 1) * self.stride + self.k

    # -- thread layout -----------------------------------------------------

    @property
    def threads_cout(self) -> int:
        """Threads along C_out: a warp, or the whole tile when smaller."""
        return min(self.tile_cout, WARP)

    @property
    def positions(self) -> int:
        """Output positions of one strip of one band."""
        return self.th_out * self.tile_w

    @property
    def smem_bytes(self) -> int:
        window = self.window_rows * self.window_cols * self.cin_per_group
        return 4 * (window + WEIGHT_CHUNK * self.tile_cout)

    # -- work and the least traffic ---------------------------------------

    @property
    def flops(self) -> int:
        return (2 * self.n * self.h_out * self.w_out * self.cout
                * self.k * self.k * self.cin_per_group)

    def min_bytes(self) -> int:
        """f32 bytes the function must move: each input (x, w, bias) read
        once, the output written once."""
        elems = (self.n * self.h * self.w * self.cin
                 + self.k * self.k * self.cin_per_group * self.cout
                 + self.cout + self.n * self.h_out * self.w_out * self.cout)
        return 4 * elems

    @property
    def n_strips(self) -> int:
        return -(-self.h_out // self.th_out)

    @property
    def n_bands(self) -> int:
        return -(-self.w_out // self.tile_w)

    def hbm_bytes(self) -> dict:
        """f32 bytes the kernel's schedule moves: every block (image,
        group, C_out tile, band) reads its band's window columns — each
        padded row once with ``carry``, ``window_rows`` a strip with
        ``halo`` — and streams its C_out tile's weights once per strip;
        the output is written once."""
        blocks = (self.n * self.groups * self.n_bands
                  * -(-self.cout_per_group // self.tile_cout))
        rows = (self.n_strips * self.tile_h + self.carry_rows
                if self.dataflow == "carry"
                else self.n_strips * self.window_rows)
        in_bytes = 4 * blocks * rows * self.window_cols * self.cin_per_group
        w_bytes = 4 * (self.n * self.n_bands * self.n_strips * self.k ** 2
                       * self.cin_per_group * self.cout)
        out_bytes = 4 * self.n * self.h_out * self.w_out * self.cout
        return dict(input=in_bytes, weights=w_bytes, output=out_bytes,
                    total=in_bytes + w_bytes + out_bytes)


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

        pad_h = (K-1-top, K-1-bottom + r_h),  r_h = (H+top+bottom-K) % s

    and likewise for the width, so that the result has ``x``'s shape.
    Each forward pad must be <= K-1 (true for 'same' and 'valid').

    Returns ``h_out``/``w_out`` (the cotangent's), the dilated cotangent
    shape ``g_dilated_shape``, the edge pads ``pad_h``/``pad_w``, the
    padded shape ``g_padded_shape`` and ``wt_shape = (K, K, Cout/groups,
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


WGRAD_TILE_ROWS = 64          # rows of the flattened (ki, kj, ci) axis
WGRAD_TILE_COUT = 64          # output channels per block
WGRAD_MIN_CHUNK_POSITIONS = 256
WGRAD_WORKSPACE_CAP = 256 * 2**20   # bytes of per-chunk partial sums


@dataclass(frozen=True)
class WeightGradPlan:
    """Launch geometry of the weight-gradient kernel
    (``kernels/csrc/trim_conv2d_wgrad.cu``); the Hopper counterpart of
    ``repro/core/conv_plan.py:552``.

        dw[ki, kj, ci, g*Cpg+co] = sum_{n, oh, ow}
            xpad[n, oh*s+ki, ow*s+kj, g*Cin_pg+ci] * dz[n, oh, ow, g*Cpg+co]

    Per group, dw is a ``(K*K*Cin_pg) x Cpg`` matrix whose rows are the
    flattened ``(ki, kj, ci)`` axis.  A block owns a tile of
    :data:`WGRAD_TILE_ROWS` rows x :data:`WGRAD_TILE_COUT` columns of it
    (one tap x a 64-channel Cin tile whenever ``Cin/g`` is a multiple of
    64; several taps when ``Cin/g`` is small, as at VGG-16's conv1 or a
    depthwise conv) and one *chunk* of the reduction.

    The TPU plan sweeps ``(n, strip of tile_go cotangent rows)`` in
    sequence into one resident accumulator.  Here the sweep is cut into
    chunks that run in parallel: a chunk is a run of ``tile_go``
    consecutive rows of the flattened ``(n, oh)`` cotangent axis (it may
    cross an image boundary; the last may be shorter).  Each chunk writes
    its partial dw into a workspace, and a second pass sums the partials
    in ascending chunk order.  ``tile_go`` — and so the chunk count — is
    a pure function of the shape: the fewest rows that give a chunk
    :data:`WGRAD_MIN_CHUNK_POSITIONS` positions, raised until the
    workspace fits :data:`WGRAD_WORKSPACE_CAP` (e.g. VGG-16 conv9 at
    batch 8: 2.36 M dw elements = 9.4 MB a chunk, 24 chunks).  With one
    chunk there is no workspace: the kernel writes dw itself.
    """

    n: int
    h: int
    w: int
    cin: int
    cout: int
    k: int
    stride: int
    pads: tuple
    groups: int
    tile_go: int

    @classmethod
    def build(cls, x_shape, w_shape, *, stride: int = 1, pad=0,
              groups: int = 1, tile_go: int | None = None
              ) -> "WeightGradPlan":
        """Plan from the forward problem's shapes; ``tile_go`` overrides
        the chunk height (cotangent rows) and is raised to the cap."""
        n, h, w, cin = x_shape
        kh, kw, cin_pg, cout = w_shape
        if kh != kw:
            raise ValueError(f"square kernels only, got {kh}x{kw}")
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
        if tile_go is None:
            tile_go = -(-WGRAD_MIN_CHUNK_POSITIONS // w_out)
        if tile_go < 1:
            raise ValueError(f"tile_go={tile_go} must be >= 1")
        chunk_bytes = 4 * kh * kw * cin_pg * cout
        max_chunks = max(1, WGRAD_WORKSPACE_CAP // chunk_bytes)
        rows = n * h_out
        tile_go = min(max(tile_go, -(-rows // max_chunks)), rows)
        return cls(n=n, h=h, w=w, cin=cin, cout=cout, k=kh, stride=stride,
                   pads=pads, groups=groups, tile_go=tile_go)

    @property
    def cin_per_group(self) -> int:
        return self.cin // self.groups

    @property
    def cout_per_group(self) -> int:
        return self.cout // self.groups

    @property
    def h_out(self) -> int:
        return (self.h + sum(self.pads[0]) - self.k) // self.stride + 1

    @property
    def w_out(self) -> int:
        return (self.w + sum(self.pads[1]) - self.k) // self.stride + 1

    @property
    def dw_shape(self) -> tuple[int, int, int, int]:
        return (self.k, self.k, self.cin_per_group, self.cout)

    @property
    def rows(self) -> int:
        """Rows of the flattened (ki, kj, ci) axis: K*K*Cin/groups."""
        return self.k * self.k * self.cin_per_group

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
        """f32 bytes the function must move: x and the cotangent read
        once, dw written once."""
        elems = (self.n * self.h * self.w * self.cin
                 + self.n * self.h_out * self.w_out * self.cout
                 + self.dw_elems)
        return 4 * elems


# ---------------------------------------------------------------------------
# 1-D plan (causal depthwise conv: the Mamba / RG-LRU temporal mixing)
# ---------------------------------------------------------------------------

SMS = 132                     # H100 SXM streaming multiprocessors
THREADS_PER_SM = 2048
PEAK_F32_FLOPS = 67e12        # H100 SXM: f32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12    # H100 SXM: HBM3
CONV1D_TILE_D = 256           # channels (one a thread) per block; the
                              # kernel's __launch_bounds__ (kMaxThreads)
CONV1D_TILE_LS = (256, 128, 64, 32, 16, 8)   # run lengths, longest first
CONV1D_MIN_WAVES = 3          # full waves of resident blocks to aim for
CONV1D_MAX_K = 8              # the kernel's instances: K = 2..8


@dataclass(frozen=True)
class Conv1dPlan:
    """Launch geometry of the causal depthwise conv1d kernel
    (``kernels/csrc/trim_conv1d.cu``); the Hopper counterpart of
    ``repro/core/conv_plan.py:759``.

        y[b, t, d] = sum_{i < K} x[b, t-K+1+i, d] * w[i, d]

    The TPU plan sweeps chunks of 512 steps in order on one core, carrying
    the ``K-1`` boundary rows in VMEM, with 1024-lane channel tiles.  On
    the card blocks run in parallel and in no order, so nothing carries
    between them.  Here a thread owns one channel of one *run* of
    ``tile_l`` timesteps and keeps the ``K-1`` previous inputs of its
    channel in registers (the shadow registers) while it walks the run;
    a block is ``tile_d`` consecutive channels (D is contiguous, so a
    warp's row loads coalesce); the grid is ``(B, D / tile_d,
    L / tile_l)``.  A run's first ``K-1`` inputs are re-read from device
    memory (zeros before t = 0): that halo is what the plan's
    :meth:`hbm_bytes` prices beyond the least traffic, the JAX plan's
    ``"trim"`` mode; a carry between runs (its ``"3dtrim"``) would save
    exactly those bytes at the price of ordered runs.  ``tile_l`` is the
    longest run that still gives :data:`CONV1D_MIN_WAVES` full waves of
    resident blocks over the 132 SMs, since a short run costs only its
    halo (3 rows in 32 at K = 4) while too few blocks leave SMs idle.
    """

    b: int
    length: int
    d: int
    k: int
    tile_l: int
    tile_d: int

    @classmethod
    def build(cls, x_shape, w_shape, *,
              tile_l: int | None = None) -> "Conv1dPlan":
        """Plan from ``x (B, L, D)`` and ``w (K, D)``, choosing ``tile_l``
        if it is left as ``None``; ``tile_d`` is :data:`CONV1D_TILE_D`, or
        D rounded up to a warp when D is narrower.  Raises ``ValueError``
        for what the kernel cannot take, so every plan it returns is one
        the kernel runs."""
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
            raise ValueError(f"B={b} > 65535, the grid's z limit")
        if not 2 <= k <= CONV1D_MAX_K:
            raise ValueError(f"K={k}: the kernel takes 2 <= K <= "
                             f"{CONV1D_MAX_K} (ops.depthwise_conv1d routes "
                             "K < 2 to the oracle)")
        tile_d = min(CONV1D_TILE_D, -(-d // 32) * 32)
        if tile_l is None:
            wave = SMS * (THREADS_PER_SM // tile_d)
            blocks = b * -(-d // tile_d)
            tile_l = next((t for t in CONV1D_TILE_LS
                           if blocks * -(-length // t)
                           >= CONV1D_MIN_WAVES * wave), CONV1D_TILE_LS[-1])
            tile_l = min(tile_l, length)
        if tile_l < 1:
            raise ValueError(f"tile_l={tile_l} must be >= 1")
        return cls(b=b, length=length, d=d, k=k, tile_l=tile_l,
                   tile_d=tile_d)

    @property
    def d_tiles(self) -> int:
        return -(-self.d // self.tile_d)

    @property
    def runs(self) -> int:
        return -(-self.length // self.tile_l)

    @property
    def grid(self) -> tuple[int, int, int]:
        """(B, channel tiles, runs)."""
        return (self.b, self.d_tiles, self.runs)

    @property
    def blocks(self) -> int:
        return self.b * self.d_tiles * self.runs

    @property
    def halo_rows(self) -> int:
        """Input rows re-read per (batch, channel): run r >= 1 re-reads
        the ``min(K-1, r * tile_l)`` rows before it."""
        r0 = max(1, -(-(self.k - 1) // self.tile_l))
        partial = sum(r * self.tile_l for r in range(1, min(r0, self.runs)))
        return partial + (self.k - 1) * max(0, self.runs - r0)

    @property
    def flops(self) -> int:
        return 2 * self.b * self.length * self.d * self.k

    def min_bytes(self) -> int:
        """f32 bytes the function must move: x and w read once, y
        written once."""
        return 4 * (2 * self.b * self.length * self.d + self.k * self.d)

    def hbm_bytes(self) -> dict:
        """f32 bytes the kernel's schedule moves: every input row once,
        plus each run's re-read halo; each block's ``K x tile_d`` weights;
        the output once."""
        inp = 4 * self.b * self.length * self.d
        halo = 4 * self.b * self.d * self.halo_rows
        weights = 4 * self.b * self.runs * self.k * self.d
        out = 4 * self.b * self.length * self.d
        return dict(input=inp, halo=halo, weights=weights, output=out,
                    total=inp + halo + weights + out)

    def bound(self) -> tuple[float, str]:
        """(ms, "bytes" or "operations"): the least time the H100 takes,
        :attr:`flops` over 67 TFLOP/s against :meth:`min_bytes` over
        3.35 TB/s."""
        ops_ms = self.flops / PEAK_F32_FLOPS * 1e3
        bytes_ms = self.min_bytes() / PEAK_BYTES_PER_S * 1e3
        return (max(ops_ms, bytes_ms),
                "operations" if ops_ms >= bytes_ms else "bytes")
