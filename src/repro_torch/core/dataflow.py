"""Cycle-stepped functional simulator of the TrIM / 3D-TrIM dataflow
(the counterpart of ``repro/core/dataflow.py``; numpy, no device).

This is the faithful-reproduction artifact for the paper's Figs. 3-5: a
K x K weight-stationary slice in which

  * activations are injected *vertically* into the rightmost PE column,
  * shift *horizontally* (right -> left) one PE per step,
  * and are re-injected *diagonally* from the Input Recycling Buffer (IRB)
    when the sliding-window band advances one row.

The IRB holds two structures (Fig. 4):

  * ``K-1`` shift registers — capture activations as they exit the leftmost
    PE column, and replay them one band later to the PE row above.  An
    activation at row-offset ``c`` only ever reaches column 0 if
    ``c <= W - K``, so the **last K-1 activations of every row never enter
    the shift registers**.
  * ``(K-1) x (K-1)`` shadow registers — the 3D-TrIM contribution: they
    capture exactly those end-of-row activations and replay them (and keep
    shifting them shadow-to-shadow for the next bands, Fig. 5).  In
    ``mode="trim"`` the shadow path is disabled and every end-of-row
    activation is **re-read from external memory**, reproducing TrIM's
    overhead (Fig. 1).

The simulator counts every external memory read and is validated against
both the analytical model (`core.conv_plan.slice_reads_per_channel`) and a
direct convolution oracle.

Functional timing note: real hardware staggers the K columns in time
(column j computes window ``x`` at cycle ``x + 2j``, psums flow top->bottom
through the product/psum registers of Fig. 3b).  The simulator advances one
*injection step* per cycle, in which every PE sees exactly the activation
the hardware would route to it; the per-PE value streams — and therefore
the memory-access counts — are identical to the staggered schedule.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.conv_plan import slice_reads_per_channel


@dataclass
class SliceStats:
    """Counters of the data movement in one slice pass."""

    memory_reads: int = 0          # external (off-chip) reads
    shift_reg_supplies: int = 0    # diagonal re-injections via shift registers
    shadow_supplies: int = 0       # diagonal re-injections via shadow registers
    horizontal_shifts: int = 0     # PE -> PE right-to-left moves
    macs: int = 0

    @property
    def ops(self) -> int:
        return 2 * self.macs

    @property
    def ops_per_memory_access(self) -> float:
        return self.ops / max(self.memory_reads, 1)


@dataclass
class StepSnapshot:
    """One injection step of the schedule — used to validate Fig. 5."""

    band: int
    step: int                      # injection index c within the band
    pe_values: np.ndarray          # (K, K) activation registers, NaN = empty
    sources: list                  # (row, source) for this step's injections
    shift_regs: list               # contents per reused row
    shadow_regs: list              # contents per reused row


class TrimSliceSim:
    """One K x K TrIM / 3D-TrIM slice, valid convolution, stride 1."""

    def __init__(self, kernel_size: int = 3, mode: str = "3dtrim",
                 record_trace: bool = False):
        if mode not in ("trim", "3dtrim"):
            raise ValueError(f"unknown mode {mode!r}")
        self.k = kernel_size
        self.mode = mode
        self.record_trace = record_trace
        self.trace: list[StepSnapshot] = []

    # -- injection source resolution ------------------------------------
    def _inject(self, band: int, row: int, c: int, ifmap: np.ndarray,
                shift_regs: list[dict], shadow_regs: list[dict],
                stats: SliceStats, sources: list) -> float:
        """Return activation ifmap[band + row, c], from the correct source."""
        k, w = self.k, ifmap.shape[1]
        value = ifmap[band + row, c]
        is_new_row = band == 0 or row == k - 1
        if is_new_row:
            stats.memory_reads += 1
            sources.append((row, "memory"))
            return value
        # Reused row: band>0, row < K-1.  Previous band saw this ifmap row
        # at row index row+1; its traversal filled shift/shadow registers.
        if c <= w - k:
            assert shift_regs[row].get(c) == value, "shift register miss"
            stats.shift_reg_supplies += 1
            sources.append((row, "shift"))
            return shift_regs[row].pop(c)
        # End-of-row activation (the last K-1 of the row).
        if self.mode == "3dtrim":
            assert shadow_regs[row].get(c) == value, "shadow register miss"
            stats.shadow_supplies += 1
            sources.append((row, "shadow"))
            return shadow_regs[row][c]
        stats.memory_reads += 1          # TrIM: re-read from memory
        sources.append((row, "memory-reread"))
        return value

    # -- main loop --------------------------------------------------------
    def run(self, ifmap: np.ndarray, weights: np.ndarray):
        """Convolve ``ifmap`` (H, W) with ``weights`` (K, K), stride 1, valid.

        Returns ``(output, stats)`` with output of shape (H-K+1, W-K+1).
        """
        k = self.k
        h, w = ifmap.shape
        assert weights.shape == (k, k)
        assert h >= k and w >= 2 * k, "ifmap too small for the IRB layout"
        out_h, out_w = h - k + 1, w - k + 1
        output = np.zeros((out_h, out_w), dtype=np.float64)
        stats = SliceStats()

        # IRB state for the *next* band, keyed by column index c.
        # shift_regs[r][c] / shadow_regs[r][c] feed PE row r of band b+1.
        shift_regs: list[dict] = [dict() for _ in range(k - 1)]
        shadow_regs: list[dict] = [dict() for _ in range(k - 1)]

        for band in range(out_h):
            pes = np.full((k, k), np.nan)
            next_shift: list[dict] = [dict() for _ in range(k - 1)]
            next_shadow: list[dict] = [dict() for _ in range(k - 1)]
            for c in range(w):
                # Horizontal movement: everything shifts one PE left; the
                # value exiting column 0 is captured by the IRB (Slice 0
                # forwards it; other slices of the core would discard it).
                exiting = pes[:, 0].copy()
                pes[:, :-1] = pes[:, 1:]
                stats.horizontal_shifts += int(np.isfinite(pes[:, :-1]).sum())
                exit_c = c - k  # column index of the value leaving column 0
                if exit_c >= 0:
                    for row in range(1, k):  # rows 1..K-1 are reused next band
                        next_shift[row - 1][exit_c] = exiting[row]
                # Vertical / diagonal injection into the rightmost column.
                sources: list = []
                for row in range(k):
                    pes[row, k - 1] = self._inject(
                        band, row, c, ifmap, shift_regs, shadow_regs,
                        stats, sources)
                    # Shadow capture: end-of-row values never reach column 0,
                    # so they are latched as they enter (3D-TrIM only).
                    if c > w - k and row >= 1:
                        next_shadow[row - 1][c] = pes[row, k - 1]
                # Compute: once the array holds a full window, all K x K PEs
                # multiply-accumulate for output column x = c - K + 1.
                x = c - k + 1
                if 0 <= x < out_w:
                    output[band, x] = float((pes * weights).sum())
                    stats.macs += k * k
                if self.record_trace:
                    self.trace.append(StepSnapshot(
                        band=band, step=c, pe_values=pes.copy(),
                        sources=sources,
                        shift_regs=[dict(s) for s in next_shift],
                        shadow_regs=[dict(s) for s in next_shadow]))
            # Final flush: after the last window, the value at column 0
            # (column index W-K) performs one more exit into the IRB.
            for row in range(1, k):
                next_shift[row - 1][w - k] = pes[row, 0]
            shift_regs, shadow_regs = next_shift, next_shadow
        return output, stats

    def expected_memory_reads(self, h: int, w: int) -> int:
        """Analytical prediction for the reads counted by :meth:`run` —
        read straight from the shared planning model (conv_plan)."""
        return slice_reads_per_channel(
            h, w, self.k, 1, shadow=(self.mode == "3dtrim"))


# ---------------------------------------------------------------------------
# Core-level simulation: P_O slices sharing one IRB (3D-TrIM) vs private
# buffers (TrIM).  Demonstrates the buffer-sharing contribution.
# ---------------------------------------------------------------------------

def core_conv(ifmap: np.ndarray, weight_stack: np.ndarray,
              mode: str = "3dtrim", shared_irb: bool | None = None):
    """Convolve one ifmap with ``P_O`` kernels (weight_stack: (P_O, K, K)).

    With a shared IRB (3D-TrIM) the external reads are those of a single
    slice: slice 0 fetches, the IRB broadcasts to the others.  Without
    sharing (TrIM orientation) every slice fetches independently.
    Returns ``(outputs (P_O, OH, OW), total_memory_reads)``.
    """
    if shared_irb is None:
        shared_irb = mode == "3dtrim"
    p_o, k, _ = weight_stack.shape
    outputs, reads = [], 0
    for s in range(p_o):
        sim = TrimSliceSim(kernel_size=k, mode=mode)
        out, stats = sim.run(ifmap, weight_stack[s])
        outputs.append(out)
        if s == 0 or not shared_irb:
            reads += stats.memory_reads
    return np.stack(outputs), reads


def reference_conv2d_valid(ifmap: np.ndarray, weights: np.ndarray
                           ) -> np.ndarray:
    """Plain nested-loop oracle for the slice simulator."""
    k = weights.shape[0]
    h, w = ifmap.shape
    out = np.zeros((h - k + 1, w - k + 1))
    for y in range(out.shape[0]):
        for x in range(out.shape[1]):
            out[y, x] = float((ifmap[y:y + k, x:x + k] * weights).sum())
    return out
