"""Device resolution (the counterpart of ``repro/kernels/runtime.py``).

The port runs on the card: an entry point given no device uses ``cuda``
and raises when PyTorch sees no GPU.  The CPU, where every kernel wrapper
runs its plain PyTorch version, is used only when a caller asks for it.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on an NVIDIA GPU and torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
