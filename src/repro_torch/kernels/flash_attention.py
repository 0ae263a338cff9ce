"""Tiled online-softmax attention (FlashAttention): the wrapper of the
Hopper kernel and its plain PyTorch version (the counterpart of
``repro/kernels/flash_attention.py``, f32).

``flash_attention`` launches the hand-written kernel of
``csrc/flash_attention.cu`` on CUDA tensors and runs
:func:`flash_attention_plain` on CPU tensors; nothing falls back.  Both
compute ``_kernel`` (``repro/kernels/flash_attention.py:31``): scores
``q . k / sqrt(D)``, an optional logit soft cap, the causal / local-window
/ ragged-edge mask with the finite value -1e30, queries right-aligned to
the keys (query i sits at position ``i + Lk - Lq``), and the online
softmax over key tiles in f32.  GQA: query head h reads KV head
``h // (Hq / Hkv)``; no K/V head is replicated.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

BLOCK_K = 64           # keys per tile, the kernel's kKeys
NEG_INF = -1e30        # the TPU kernel's mask value

# Kernel launches: each successful launch adds one.
LAUNCHES = {"flash_attention": 0}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _check(q, k, v, causal, soft_cap, window) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type not in ("cpu", "cuda") or t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}: "
                             "q, k and v must share a CPU or CUDA device")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}; this kernel takes "
                             "float32 only (bf16 is ROADMAP Queue 1 item 2g)")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be 4-D (B, L, H, D) with a "
                             f"contiguous head dim; got {tuple(t.shape)} "
                             f"strides {t.stride()}")
    b, lq, hq, d = q.shape
    _, lk, hkv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be (B, Lk, Hkv, D) for q {tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    if causal and lq > lk:
        raise ValueError(f"causal attention with Lq={lq} > Lk={lk} leaves "
                         "query rows with no key")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be >= 1")
    if soft_cap is not None and soft_cap <= 0:
        raise ValueError(f"soft_cap={soft_cap} must be > 0")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          soft_cap: float | None = None,
                          window: int | None = None,
                          block_k: int = BLOCK_K) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the key tiles of ``block_k``
    keys in order, each one's scores, soft cap and -1e30 mask, and the
    online max / sum / accumulator update of ``_kernel``, for all query
    rows at once.  Tiles before the first query's window are skipped, as
    the kernel skips the tiles masked for all rows of a block (exactly:
    such a tile adds 0 after a row's first valid key and is wiped before
    it).  q: (B, Lq, Hq, D); k/v: (B, Lk, Hkv, D)."""
    b, lq, hq, d = q.shape
    _, lk, hkv, _ = k.shape
    group = hq // hkv
    sm_scale = 1.0 / math.sqrt(d)
    off = lk - lq
    qg = q.reshape(b, lq, hkv, group, d).permute(0, 2, 3, 1, 4).float()
    q_pos = torch.arange(lq, device=q.device) + off
    m = torch.full((b, hkv, group, lq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, group, lq, 1), device=q.device)
    acc = torch.zeros((b, hkv, group, lq, d), device=q.device)
    # the last query sees every key up to Lk - 1: only a window skips
    k_begin = max(0, off - window + 1) if window is not None else 0
    for k0 in range(k_begin // block_k * block_k, lk, block_k):
        kc = k[:, k0:k0 + block_k].float()
        vc = v[:, k0:k0 + block_k].float()
        s = torch.einsum("bhgqd,bchd->bhgqc", qg, kc) * sm_scale
        if soft_cap is not None:
            s = soft_cap * torch.tanh(s / soft_cap)
        k_pos = torch.arange(k0, k0 + kc.shape[1], device=q.device)
        mask = torch.ones((lq, kc.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqc,bchd->bhgqd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, lq, hq, d).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, soft_cap: float | None = None,
                    window: int | None = None) -> torch.Tensor:
    """q: (B, Lq, Hq, D); k/v: (B, Lk, Hkv, D), f32, head dim contiguous
    (other strides are read as they are) -> (B, Lq, Hq, D).

    On CUDA tensors, one launch of the hand-written kernel (counted in
    ``LAUNCHES``); on CPU tensors, :func:`flash_attention_plain`.  Raises
    ``ValueError`` for what the kernel cannot take: a dtype other than
    f32, Hq % Hkv != 0, causal with Lq > Lk.  Any head_dim: D > 256 runs
    the kernel's wide-head route (D in chunks, 256 output columns a
    block).
    """
    _check(q, k, v, causal, soft_cap, window)
    if q.device.type == "cpu":
        with torch.no_grad():
            return flash_attention_plain(q, k, v, causal=causal,
                                         soft_cap=soft_cap, window=window)
    b, lq, hq, d = q.shape
    _, lk, hkv, _ = k.shape
    lib = build.library("flash_attention")
    o = torch.empty((b, lq, hq, d), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, lq, lk, hq, hkv, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *o.stride()[:3], int(causal),
            0 if window is None else window,
            0.0 if soft_cap is None else soft_cap, 1.0 / math.sqrt(d),
            stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err} "
            f"({lib.flash_attention_error_string(err).decode()}) for q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, causal={causal}, "
            f"soft_cap={soft_cap}, window={window}")
    LAUNCHES["flash_attention"] += 1
    return o
