"""The paper's kernel tiling (copied from ``repro/core/tiling.py``).

A K x K kernel with K > ``native_k`` is split into ``ceil(K / 3)^2``
sub-kernels of at most 3 x 3 taps, each run as its own conv on a 'valid'
slice of the padded input; the adder tree sums their outputs
(``kernels/ops.py``).  The TPU VMEM planner of the JAX module
(``plan_conv_tiles``, ``ConvTilePlan``) is not copied: ``ConvPlan`` is the
port's planner.
"""

from __future__ import annotations


def subkernel_decomposition(k: int, native_k: int = 3
                            ) -> list[tuple[int, int, int, int]]:
    """Split a K x K kernel into (row_off, col_off, kh, kw) sub-kernels.

    Row-major over the tiles; the extents are the un-padded ones, so an
    11 x 11 kernel gives 3 x 3, 3 x 2, 2 x 3 and 2 x 2 pieces (rows and
    columns of extents 3, 3, 3, 2)."""
    if k <= native_k:
        return [(0, 0, k, k)]
    subs = []
    for r0 in range(0, k, native_k):
        for c0 in range(0, k, native_k):
            subs.append((r0, c0, min(native_k, k - r0), min(native_k, k - c0)))
    return subs
