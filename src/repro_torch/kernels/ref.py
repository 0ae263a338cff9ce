"""Plain PyTorch oracles (the counterpart of ``repro/kernels/ref.py``).

Test oracles, independent of the kernel path and of its plain version: the
convolution is one einsum over unfolded patches, not a tap loop.  On the
card, run them with ``torch.backends.cuda.matmul.allow_tf32 = False`` (and
``torch.backends.cudnn.allow_tf32 = False``) so f32 stays f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.conv_plan import same_pads

ACTIVATIONS = {
    None: lambda a: a,
    "relu": torch.relu,
    # jax.nn.gelu, the JAX reference's activation, is the tanh form
    "gelu": lambda a: F.gelu(a, approximate="tanh"),
    "silu": F.silu,
}


def epilogue(y: torch.Tensor, bias: torch.Tensor | None = None,
             activation: str | None = None) -> torch.Tensor:
    """Bias + activation epilogue (fused into the conv kernels)."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; "
                         f"choose from {sorted(ACTIVATIONS, key=str)}")
    if bias is not None:
        y = y + bias
    return ACTIVATIONS[activation](y)


def conv_pads(h: int, w: int, k: int, stride: int, padding: str):
    """``((top, bottom), (left, right))`` of a 'same' or 'valid' conv;
    'same' is XLA's, asymmetric at stride > 1."""
    if padding == "same":
        return same_pads(h, k, stride), same_pads(w, k, stride)
    if padding == "valid":
        return (0, 0), (0, 0)
    raise ValueError(f"padding={padding!r} must be 'same' or 'valid'")


def pad_nhwc(x: torch.Tensor, pads) -> torch.Tensor:
    (pt, pb), (pl, pr) = pads
    return F.pad(x, (0, 0, pl, pr, pt, pb))


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           padding: str = "same", feature_group_count: int = 1,
           bias: torch.Tensor | None = None,
           activation: str | None = None) -> torch.Tensor:
    """2D (grouped) convolution oracle.

    x: (N, H, W, Cin); w: (K, K, Cin/groups, Cout); bias: (Cout,) or None.
    """
    k, g = w.shape[0], feature_group_count
    cin_pg, cout = w.shape[2], w.shape[3]
    xp = pad_nhwc(x, conv_pads(x.shape[1], x.shape[2], k, stride, padding))
    # (N, Ho, Wo, Cin, K, K) patches, channels split into groups
    patches = xp.unfold(1, k, stride).unfold(2, k, stride)
    n, ho, wo = patches.shape[:3]
    patches = patches.reshape(n, ho, wo, g, cin_pg, k, k)
    wg = w.reshape(k, k, cin_pg, g, cout // g)
    y = torch.einsum("nhwgcij,ijcgo->nhwgo", patches, wg)
    return epilogue(y.reshape(n, ho, wo, cout), bias, activation)


def maxpool2d(x: torch.Tensor, stride: int, window: int) -> torch.Tensor:
    """VALID max pooling of an NHWC tensor (VGG 2x2/s2, AlexNet 3x3/s2):
    ``layers._maxpool``'s ``reduce_window`` with a -inf init, which never
    wins against a real value because VALID windows hold no padding."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=window,
                     stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()
