"""Hopper launch geometry for one 3D-TrIM convolution.

The counterpart of ``repro.core.conv_plan.ConvPlan`` for the H100 kernels
of ``kernels/csrc/trim_conv2d.cu``.  The TPU plan sizes its strips for an
8 MiB VMEM budget and 128-lane C_out tiles; neither applies to the card,
where a block has at most 227 KB of shared memory.  So a block here owns a
*column band* of ``tile_w`` output columns as well as a C_out tile, and
holds the band's input window for all ``Cin/groups`` channels:

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
