"""Plain PyTorch oracles (the counterpart of ``repro/kernels/ref.py``).

Test oracles, independent of the kernel path and of its plain version: the
convolution is one einsum over unfolded patches, not a tap loop, and its
gradients are autograd through that einsum; attention is one softmax over
the masked logits, with no blocking and no online normaliser; the causal
depthwise conv1d is the JAX tap sum over the whole padded sequence, with
no runs or halos; the int8 conv (``conv2d_quantized``) is one exact
float64 einsum over unfolded patches, and the quantization helpers keep
JAX's order of operations bit for bit.  On the card, run them with
``torch.backends.cuda.matmul.allow_tf32 = False`` (and
``torch.backends.cudnn.allow_tf32 = False``) so f32 stays f32.

bf16 (the bf16 routes of the conv kernels): ``conv2d`` on bf16 operands
sums in f32 on the widened operands, applies the epilogue in f32 and casts
once, as JAX's bf16 kernels do; ``epilogue`` and ``maxpool2d`` run on the
tensors they are given, so on bf16 ones in bf16 arithmetic, as JAX runs
the K > 8 adder tree's epilogue and the pools between layers.
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
    bf16 operands: the conv and epilogue in f32, one cast to bf16.
    """
    if x.dtype == torch.bfloat16:
        y = conv2d(x.float(), w.float(), stride=stride, padding=padding,
                   feature_group_count=feature_group_count,
                   bias=None if bias is None else bias.float(),
                   activation=activation)
        return y.to(torch.bfloat16)
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


def quantize_int8(x: torch.Tensor, scale, zero_point=0) -> torch.Tensor:
    """Affine int8 quantization ``q = clip(round(x / scale) + zp, -128,
    127)`` (``repro/kernels/ref.py:48``), in JAX's order: the f32 quotient
    rounded half to even, the zero point added in f32, then the clip.

    ``scale`` / ``zero_point`` are scalars (per-tensor activations) or
    broadcastable tensors (per-channel weights with ``zero_point=0``).
    Both become tensors on ``x``'s device first: on a CUDA tensor,
    PyTorch divides by a CPU scalar as a multiply by its reciprocal, which
    can round differently from the division.
    """
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    zp = torch.as_tensor(zero_point, device=x.device).to(torch.float32)
    q = torch.round(x.float() / scale) + zp
    return q.clamp(-128, 127).to(torch.int8)


def weight_scales_int8(w: torch.Tensor) -> torch.Tensor:
    """Per-out-channel symmetric weight scales ``max|w| / 127`` with a
    1e-12 floor (``repro/kernels/ref.py:59``).  w: (K, K, Cin/g, Cout) ->
    (Cout,) f32; the zero point is 0."""
    amax = w.float().abs().amax(dim=(0, 1, 2))
    # a device tensor, not a Python scalar (see quantize_int8)
    return amax.clamp_min(1e-12) / torch.tensor(127.0, device=w.device)


def dequant_params(w_q: torch.Tensor, w_scale: torch.Tensor, x_scale,
                   x_zero_point, bias: torch.Tensor | None = None) -> tuple:
    """The epilogue ``y = (acc_i32 + bias_q) * scale`` of an int8 conv
    (``repro/kernels/ref.py:69``): ``scale = x_scale * w_scale`` per out
    channel (f32) and the requantized int32 bias

        bias_q = -z_x * colsum(w_q) + round(bias / scale).

    'same' borders are padded with the zero point, so the zero-point
    correction is the same at every output position and exactly integer;
    the real bias is rounded onto the scale grid.  The epilogue is then an
    exact int32 add and ONE rounded f32 multiply, with no mul + add pair a
    compiler could contract into an FMA.  w_q: (K, K, Cin/g, Cout) int8,
    w_scale: (Cout,) f32; returns ``(scale, bias_q)``, (Cout,) f32 and
    int32.
    """
    dev = w_q.device
    colsum = w_q.to(torch.int32).sum(dim=(0, 1, 2), dtype=torch.int32)
    scale = torch.as_tensor(x_scale, dtype=torch.float32, device=dev) \
        * w_scale.float()
    zp = torch.as_tensor(x_zero_point, device=dev).to(torch.int32)
    bias_q = -zp * colsum
    if bias is not None:
        bias_q = bias_q + torch.round(bias.float() / scale).to(torch.int32)
    return scale, bias_q


def exact_int_products(a: torch.Tensor, b: torch.Tensor,
                       equation: str) -> torch.Tensor:
    """``einsum(equation, a, b)`` of integer tensors, exactly, as int32.

    CUDA has no integer matmul, so the operands go through float64: every
    int8 x int8 product is at most 2^14 in magnitude, and a sum of them
    stays an integer below 2^53 for up to 2^39 terms (a VGG-16 output
    sums 4,608), so every float64 product and partial sum is exact, in
    any order, and the conversion to int32 loses nothing."""
    return torch.einsum(equation, a.double(), b.double()).to(torch.int32)


def conv2d_quantized(x_q: torch.Tensor, w_q: torch.Tensor, *, x_scale,
                     x_zero_point, w_scale: torch.Tensor,
                     bias: torch.Tensor | None = None, stride: int = 1,
                     padding: str = "same", feature_group_count: int = 1,
                     activation: str | None = None) -> torch.Tensor:
    """Int8 quantized conv oracle (``repro/kernels/ref.py:104``): int32
    accumulation, then the f32 dequant epilogue of :func:`dequant_params`.

    x_q: int8 (N, H, W, Cin); w_q: int8 (K, K, Cin/g, Cout); w_scale:
    (Cout,) per-out-channel symmetric scales; ``x_scale`` /
    ``x_zero_point`` the per-tensor affine activation quantization.
    'same' padding pads with the zero point (the quantized image of 0.0).
    The accumulator is one einsum over unfolded patches
    (:func:`exact_int_products`: float64, exact, converted to int32), not
    the plain version's tap loop.  Returns f32.
    """
    k, g = w_q.shape[0], feature_group_count
    cin_pg, cout = w_q.shape[2], w_q.shape[3]
    zp = int(x_zero_point)
    (pt, pb), (pl, pr) = conv_pads(x_q.shape[1], x_q.shape[2], k, stride,
                                   padding)
    xp = F.pad(x_q, (0, 0, pl, pr, pt, pb), value=zp)
    patches = xp.unfold(1, k, stride).unfold(2, k, stride)
    n, ho, wo = patches.shape[:3]
    patches = patches.reshape(n, ho, wo, g, cin_pg, k, k)
    wg = w_q.reshape(k, k, cin_pg, g, cout // g)
    acc = exact_int_products(patches, wg, "nhwgcij,ijcgo->nhwgo")
    scale, bias_q = dequant_params(w_q, w_scale, x_scale, zp, bias)
    y = (acc.reshape(n, ho, wo, cout) + bias_q).float() * scale
    return epilogue(y, None, activation)


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
    D), the trailing inputs; x_t: (B, D).  Returns (new_state, y_t), in
    the dtype JAX's promotion gives (the window's: state and x_t
    promoted; y_t: the window and w promoted).

    The state is the decode-time image of the shadow registers: the K-1
    values carried across step boundaries.  The window sum runs over k in
    the order of :func:`depthwise_conv1d`, in f32 (bf16 operands widened:
    exact products) and cast once, which is the ``trim_conv1d`` kernel's
    arithmetic on bf16, so stepping through a sequence gives the full
    conv bit for bit (in f32 the oracle's, in bf16 the kernel's).
    """
    window = torch.cat([state, x_t[:, None, :]], dim=1)      # (B, K, D)
    out = torch.promote_types(window.dtype, w.dtype)
    acc = torch.promote_types(out, torch.float32)   # bf16 sums in f32
    y_t = sum(window[:, i].to(acc) * w[i].to(acc) for i in range(w.shape[0]))
    return window[:, 1:], y_t.to(out)


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
