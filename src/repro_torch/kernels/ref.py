"""Plain PyTorch oracles (the counterpart of ``repro/kernels/ref.py``).

Test oracles, independent of the kernel path and of its plain version: the
convolution is one einsum over unfolded patches, not a tap loop, and its
gradients are autograd through that einsum; attention is one softmax over
the masked logits, with no blocking and no online normaliser; the causal
depthwise conv1d is the JAX tap sum over the whole padded sequence, with
no runs or halos.  On the card, run them with
``torch.backends.cuda.matmul.allow_tf32 = False`` (and
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


def conv2d_grads(x: torch.Tensor, w: torch.Tensor, gy: torch.Tensor, *,
                 stride: int = 1, padding: str = "same",
                 feature_group_count: int = 1) -> tuple:
    """(dx, dw) oracle: ``torch.autograd.grad`` through :func:`conv2d` (the
    counterpart of ``repro/kernels/ref.py:137``, which is ``jax.vjp`` of
    the XLA convolution)."""
    with torch.enable_grad():
        x = x.detach().requires_grad_()
        w = w.detach().requires_grad_()
        y = conv2d(x, w, stride=stride, padding=padding,
                   feature_group_count=feature_group_count)
        return torch.autograd.grad(y, (x, w), gy)


def conv2d_input_grad(x: torch.Tensor, w: torch.Tensor, gy: torch.Tensor,
                      **kw) -> torch.Tensor:
    """Input cotangent of the conv2d oracle."""
    return conv2d_grads(x, w, gy, **kw)[0]


def conv2d_weight_grad(x: torch.Tensor, w: torch.Tensor, gy: torch.Tensor,
                       **kw) -> torch.Tensor:
    """Weight cotangent of the conv2d oracle."""
    return conv2d_grads(x, w, gy, **kw)[1]


def maxpool2d(x: torch.Tensor, stride: int, window: int) -> torch.Tensor:
    """VALID max pooling of an NHWC tensor (VGG 2x2/s2, AlexNet 3x3/s2):
    ``layers._maxpool``'s ``reduce_window`` with a -inf init, which never
    wins against a real value because VALID windows hold no padding."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=window,
                     stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv1d oracle (``repro/kernels/ref.py:170``; the
    Mamba / RG-LRU temporal conv).  x: (B, L, D); w: (K, D).

    ``y[b, t, d] = sum_k x[b, t-K+1+k, d] * w[k, d]`` with zero left
    padding, summed from 0 in the JAX order k = 0..K-1, every product
    rounded before its add.
    """
    k, length = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, i:i + length] * w[i] for i in range(k))


def depthwise_conv1d_step(state: torch.Tensor, x_t: torch.Tensor,
                          w: torch.Tensor):
    """Single decode step (``repro/kernels/ref.py:180``).  state: (B, K-1,
    D), the trailing inputs; x_t: (B, D).  Returns (new_state, y_t).

    The state is the decode-time image of the shadow registers: the K-1
    values carried across step boundaries.  The window sum runs over k in
    the order of :func:`depthwise_conv1d`, so stepping through a sequence
    gives the full conv bit for bit.
    """
    window = torch.cat([state, x_t[:, None, :]], dim=1)      # (B, K, D)
    y_t = sum(window[:, i] * w[i] for i in range(w.shape[0]))
    return window[:, 1:], y_t


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, logits_soft_cap: float | None = None,
              window: int | None = None) -> torch.Tensor:
    """Dense GQA attention oracle (``repro/kernels/ref.py:191``).

    q: (B, Lq, Hq, D); k/v: (B, Lk, Hkv, D); Hq % Hkv == 0; query head h
    reads KV head ``h // (Hq / Hkv)``.  Queries are right-aligned (query i
    sits at position ``i + Lk - Lq``); ``window`` is an optional local span
    (RecurrentGemma).  Masked logits are -1e30 before one softmax.
    """
    b, lq, hq, d = q.shape
    _, lk, hkv, _ = k.shape
    group = hq // hkv
    qg = q.reshape(b, lq, hkv, group, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / float(d) ** 0.5
    if logits_soft_cap is not None:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
    q_pos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
    k_pos = torch.arange(lk, device=q.device)[None, :]
    mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    logits = torch.where(mask, logits.float(), -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, lq, hq, d)
