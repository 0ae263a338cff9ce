"""Modality frontends (the counterpart of ``repro/models/frontends.py``).

The LM configs take precomputed patch embeddings (``batch["vision"]``);
``reference_vision_stem`` is a demonstration patch-embed stem on the TrIM
conv kernels, and ``anyres_tile_count`` sizes LLaVA-NeXT's vision tokens.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops


def reference_vision_stem(images: torch.Tensor, patch_w: torch.Tensor,
                          impl: str = "trim") -> torch.Tensor:
    """images: (N, H, W, 3); patch_w: (P, P, 3, D) -> (N, (H/P)*(W/P), D).

    A patch embed is a stride-P 'valid' conv: non-overlapping windows, so
    no row is ever carried.  P > 8 runs the kernel tiling's adder tree
    (``ops.conv2d``): P = 14 is 25 sub-kernels of at most 3 x 3."""
    p = patch_w.shape[0]
    feat = ops.conv2d(images, patch_w, stride=p, padding="valid", impl=impl)
    n, hp, wp, d = feat.shape
    return feat.reshape(n, hp * wp, d)


def anyres_tile_count(image_hw: tuple[int, int], tile: int = 336,
                      patch: int = 14) -> int:
    """LLaVA-NeXT anyres: number of vision tokens for an image resolution
    (base tile + grid tiles), used to size input_specs."""
    h, w = image_hw
    grid = (-(-h // tile)) * (-(-w // tile))
    per_tile = (tile // patch) ** 2
    return (1 + grid) * per_tile
