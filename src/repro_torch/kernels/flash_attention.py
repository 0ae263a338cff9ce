"""Tiled online-softmax attention (FlashAttention): the wrapper of the
Hopper kernel and its plain PyTorch version (the counterpart of
``repro/kernels/flash_attention.py``, f32 and bf16).

``flash_attention`` launches the hand-written kernel of
``csrc/flash_attention.cu`` on CUDA tensors and runs
:func:`flash_attention_plain` on CPU tensors; nothing falls back.  Both
compute ``_kernel`` (``repro/kernels/flash_attention.py:31``): scores
``q . k / sqrt(D)``, an optional logit soft cap, the causal / local-window
/ ragged-edge mask with the finite value -1e30, queries right-aligned to
the keys (query i sits at position ``i + Lk - Lq``), and the online
softmax over key tiles in f32.  GQA: query head h reads KV head
``h // (Hq / Hkv)``; no K/V head is replicated.

bf16 q, k and v launch ``flash_attention_bf16``: the same kernels on bf16
tiles, the narrow route's products on the bf16 tensor cores (Q K^T exact
in f32; P split into bf16 hi and lo halves against the exact V, which
keep each weight to within 2^-16 of itself) and the online softmax in f32
(``_kernel`` widens q, k and v, ``repro/kernels/flash_attention.py:44-45,
:66``), o rounded once to bf16 (``:73``); the plain version widens and
casts once.

Under autograd (grad enabled and q, k or v requiring grad) the call goes
through ``_FlashAttentionFn``: its forward also keeps the row log-sum-exp
``lse = m + log(max(l, 1e-30))`` (B, Hq, Lq), which the kernel writes when
it is given a pointer for it (``o`` is bitwise the same either way); its
backward launches the kernels of ``csrc/flash_attention_bwd.cu`` (dQ,
which first corrects lse and forms delta from its own recomputed scores,
then each query head's partial dK and dV, then, for a GQA group G > 1,
their sum in head order; geometry from :func:`bwd_plan`) on CUDA tensors
and runs :func:`flash_attention_backward_plain` on CPU tensors.  The JAX package
has no backward kernel: it differentiates ``ops.attention(impl=
"chunked")`` through XLA.  The backward covers D <= 256 (the forward's
narrow route); D > 256 under grad raises ``NotImplementedError``.

bf16 under autograd runs the same three kernels' bf16 route
(``flash_attention_bwd_{dq,dkdv,sum}_bf16``): JAX trains through
``chunked_attention``, which widens q, k and v to f32 and rounds o once
(``repro/kernels/ops.py:845-846, :863, :920``), so under ``jax.vjp`` the
bf16 gradient is f32 math on the widened values, rounded once per
output.  The kernels take S = Q K^T and dP = dO V^T on the bf16 tensor
cores (exact products, f32 sums) and split P and dS into bf16 hi and lo
halves against the exact second operand for dV, dK and dQ; the row
statistics, the per-head f32 partials and their head-order sum are the
f32 route's, and each gradient is rounded once to bf16 at its store.
The plain backward widens and casts once likewise.  The forward's lse is
f32 on both routes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import build

BLOCK_K = 64           # keys per tile, the kernel's kKeys
MAX_BWD_D = 256        # the backward kernels' widest head, kMaxDp
# The backward kernels' geometry (csrc/flash_attention_bwd.cu's constants;
# tests/test_torch_flash_bwd_plan.py holds the two together)
BWD_WARPS = 4          # warps a block, both kernels (kWarps)
BWD_BLOCK_ROWS = 64    # resident rows: dQ rows, dK/dV keys (kBlockRows)
BWD_BLOCK_K = 16       # streamed rows a ring stage (kTile): the dQ
                       # kernel's keys, dK/dV's query positions; the plain
                       # backward's key tile
BWD_STAGES = 2         # the cp.async ring's stages (kStages)
BWD_SUM_THREADS = 256  # threads a block of the partials' sum, four
                       # elements a thread (kSumThreads)
NEG_INF = -1e30        # the TPU kernel's mask value
WIDE_BWD = ("the flash-attention backward takes head_dim <= 256; the wide "
            "route's backward is ROADMAP Queue 2 C item 8 (the flash "
            "backward)")

# Kernel launches: each successful launch adds one, under its route's key
# (flash_attention: f32, flash_attention_bf16).  The forward's count
# includes the launches under autograd (and a remat recompute); the
# backward's kernels count in BWD_LAUNCHES, their bf16 route under the
# same names with _bf16 (the sum only where G > 1).
LAUNCHES = {"flash_attention": 0, "flash_attention_bf16": 0}
BWD_LAUNCHES = {"flash_attention_bwd_dkdv": 0, "flash_attention_bwd_dq": 0,
                "flash_attention_bwd_sum": 0,
                "flash_attention_bwd_dkdv_bf16": 0,
                "flash_attention_bwd_dq_bf16": 0,
                "flash_attention_bwd_sum_bf16": 0}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, BWD_LAUNCHES):
        for key in counts:
            counts[key] = 0


def _check(q, k, v, causal, soft_cap, window, *,
           dtypes=(torch.float32, torch.bfloat16)) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type not in ("cpu", "cuda") or t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}: "
                             "q, k and v must share a CPU or CUDA device")
        if t.dtype not in dtypes or t.dtype != q.dtype:
            raise ValueError(
                f"{name} is {t.dtype}, q {q.dtype}; this kernel takes q, k "
                f"and v all of one of {[str(d) for d in dtypes]}")
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


def _plain_forward(q, k, v, *, causal, soft_cap, window, block_k):
    """The kernel's function in plain PyTorch -> (o, lse): the key tiles
    of ``block_k`` keys in order, each one's scores, soft cap and -1e30
    mask, and the online max / sum / accumulator update of ``_kernel``,
    for all query rows at once; ``lse`` (B, Hq, Lq) is ``m + log(max(l,
    1e-30))``.  Tiles before the first query's window are skipped, as the
    kernel skips the tiles masked for all rows of a block (exactly: such a
    tile adds 0 after a row's first valid key and is wiped before it).
    f32, or float64 throughout where q is float64 (an oracle of the
    kernel's arithmetic, as for the backward)."""
    b, lq, hq, d = q.shape
    _, lk, hkv, _ = k.shape
    group = hq // hkv
    sm_scale = 1.0 / math.sqrt(d)
    off = lk - lq
    dt = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.reshape(b, lq, hkv, group, d).permute(0, 2, 3, 1, 4).to(dt)
    q_pos = torch.arange(lq, device=q.device) + off
    m = torch.full((b, hkv, group, lq, 1), NEG_INF, dtype=dt,
                   device=q.device)
    l = torch.zeros((b, hkv, group, lq, 1), dtype=dt, device=q.device)
    acc = torch.zeros((b, hkv, group, lq, d), dtype=dt, device=q.device)
    for k0 in range(_first_tile(lq, lk, window, block_k), lk, block_k):
        kc = k[:, k0:k0 + block_k].to(dt)
        vc = v[:, k0:k0 + block_k].to(dt)
        s = torch.einsum("bhgqd,bchd->bhgqc", qg, kc) * sm_scale
        if soft_cap is not None:
            s = soft_cap * torch.tanh(s / soft_cap)
        s = torch.where(_mask(q_pos, k0, kc.shape[1], causal, window), s,
                        NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqc,bchd->bhgqd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    lse = (m + torch.log(torch.clamp(l, min=1e-30))).reshape(b, hq, lq)
    return out.permute(0, 3, 1, 2, 4).reshape(b, lq, hq, d).to(q.dtype), lse


def _first_tile(lq: int, lk: int, window, block_k: int) -> int:
    """The first key tile any query sees: the last query sees every key up
    to Lk - 1, so only a window skips tiles."""
    k_begin = max(0, lk - lq - window + 1) if window is not None else 0
    return k_begin // block_k * block_k


def _mask(q_pos, k0: int, n: int, causal: bool, window):
    """Valid (query, key) pairs of keys [k0, k0 + n): (Lq, n) bool."""
    k_pos = torch.arange(k0, k0 + n, device=q_pos.device)
    mask = torch.ones((q_pos.shape[0], n), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          soft_cap: float | None = None,
                          window: int | None = None,
                          block_k: int = BLOCK_K) -> torch.Tensor:
    """The kernel's function in plain PyTorch (see :func:`_plain_forward`):
    bf16 operands widened to f32, o cast once to q's dtype; float64
    operands computed in float64.  q: (B, Lq, Hq, D); k/v: (B, Lk, Hkv,
    D)."""
    return _plain_forward(q, k, v, causal=causal, soft_cap=soft_cap,
                          window=window, block_k=block_k)[0]


def flash_attention_backward_plain(q, k, v, lse, do, *, causal=True,
                                   soft_cap=None, window=None,
                                   block_k: int = BWD_BLOCK_K):
    """The backward kernels' function in plain PyTorch -> (dq, dk, dv).

    Scores are recomputed key tile by key tile of ``block_k`` keys, in the
    order the dQ kernel takes them, twice.  First the rows' statistics,
    with the forward's ``lse`` (B, Hq, Lq) as the reference point: ``e =
    exp(y - lse)`` for a valid pair (y the scaled, capped score), ``lse' =
    lse + log(sum e)``, ``delta = sum(e dP) / sum(e)``, so that P is an
    exact softmax of these scores (``csrc/flash_attention_bwd.cu``, "Row
    statistics").  Then ``p = exp(y - lse')``, ``dS = P (dP - delta)``
    times ``1 - tanh^2`` under the soft cap, ``dV = P^T dO``, ``dK = scale
    dS^T Q``, ``dQ = scale dS K`` (the G heads of a KV head summed into
    its dK and dV).  q, do: (B, Lq, Hq, D); k, v: (B, Lk, Hkv, D).  f32,
    or float64 throughout where q is float64 (an oracle of the kernels'
    arithmetic: ``chip_smoke.py`` holds them to it at full-width logits,
    where two f32 computations of this function part by more than
    ``BWD_TOLERANCE``)."""
    b, lq, hq, d = q.shape
    _, lk, hkv, _ = k.shape
    group = hq // hkv
    sm_scale = 1.0 / math.sqrt(d)
    dt = torch.float64 if q.dtype == torch.float64 else torch.float32

    def rows(t):      # (B, Lq, Hq, X) -> (B, Hkv, G, Lq, X)
        return t.reshape(b, lq, hkv, group, -1).permute(0, 2, 3, 1, 4)

    qg, dog = rows(q.to(dt)), rows(do.to(dt))
    q_pos = torch.arange(lq, device=q.device) + lk - lq
    tiles = range(_first_tile(lq, lk, window, block_k), lk, block_k)

    def tile(k0):
        """(K, V, y, the cap's 1 - tanh^2 or None, mask, dP) of a tile."""
        kc = k[:, k0:k0 + block_k].to(dt)
        vc = v[:, k0:k0 + block_k].to(dt)
        y = torch.einsum("bhgqd,bchd->bhgqc", qg, kc) * sm_scale
        chain = None
        if soft_cap is not None:
            th = torch.tanh(y / soft_cap)
            y, chain = soft_cap * th, 1.0 - th * th
        mask = _mask(q_pos, k0, kc.shape[1], causal, window)
        dp = torch.einsum("bhgqd,bchd->bhgqc", dog, vc)
        return kc, vc, y, chain, mask, dp

    lse_g = lse.reshape(b, hkv, group, lq, 1).to(dt)
    l2 = torch.zeros_like(lse_g)
    t2 = torch.zeros_like(lse_g)
    for k0 in tiles:
        _, _, y, _, mask, dp = tile(k0)
        e = torch.where(mask, torch.exp(y - lse_g), 0.0)
        l2 = l2 + e.sum(-1, keepdim=True)
        t2 = t2 + (e * dp).sum(-1, keepdim=True)
    lse_g = lse_g + torch.log(l2)
    delta = t2 / l2

    dq = torch.zeros_like(qg)
    dk = torch.zeros((b, lk, hkv, d), dtype=dt, device=q.device)
    dv = torch.zeros((b, lk, hkv, d), dtype=dt, device=q.device)
    for k0 in tiles:
        kc, _, y, chain, mask, dp = tile(k0)
        p = torch.where(mask, torch.exp(y - lse_g), 0.0)
        ds = p * (dp - delta)
        if chain is not None:
            ds = ds * chain
        dv[:, k0:k0 + block_k] = torch.einsum("bhgqc,bhgqd->bchd", p, dog)
        dk[:, k0:k0 + block_k] = torch.einsum("bhgqc,bhgqd->bchd", ds,
                                              qg) * sm_scale
        dq = dq + torch.einsum("bhgqc,bchd->bhgqd", ds, kc)
    dq = (dq * sm_scale).permute(0, 3, 1, 2, 4).reshape(b, lq, hq, d)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@dataclass(frozen=True)
class BwdPlan:
    """The backward kernels' geometry for one shape: the padded head dim
    (the kernels' template instance), each launch's blocks (``sum_blocks``
    0: G = 1, no sum) and the shape of the heads' partials, which the
    wrapper allocates (``()`` for G = 1: dK and dV are written directly)."""
    dp: int
    group: int
    dq_blocks: int
    dkdv_blocks: int
    sum_blocks: int
    scratch: tuple

    @property
    def scratch_bytes(self) -> int:
        return 4 * math.prod(self.scratch) if self.scratch else 0


def bwd_plan(b: int, lq: int, lk: int, hq: int, hkv: int, d: int) -> BwdPlan:
    """The grids and scratch of the backward kernels for q (B, Lq, Hq, D)
    and k, v (B, Lk, Hkv, D), by the rules of their launchers: dQ one block
    per (64 rows, KV head, batch), a row one (position, head of the GQA
    group); dK/dV one per (64-key tile, query head, batch), each writing
    its head's partial dK and dV into scratch (2, G, B, Lk, Hkv, D) when
    G > 1; the sum one thread per four gradient elements."""
    if d > MAX_BWD_D:
        raise NotImplementedError(WIDE_BWD)
    group = hq // hkv
    n = b * lk * hkv * d
    return BwdPlan(
        dp=64 if d <= 64 else 128 if d <= 128 else 256, group=group,
        dq_blocks=-(-lq * group // BWD_BLOCK_ROWS) * hkv * b,
        dkdv_blocks=-(-lk // BWD_BLOCK_ROWS) * hq * b,
        sum_blocks=-(-n // (4 * BWD_SUM_THREADS)) if group > 1 else 0,
        scratch=(2, group, b, lk, hkv, d) if group > 1 else ())


def _launch_forward(q, k, v, causal, soft_cap, window, lse=None):
    """One launch of ``flash_attention_f32`` (``flash_attention_bf16`` for
    bf16 operands; o in q's dtype); ``lse``, a contiguous (B, Hq, Lq) f32
    tensor or None, receives the rows' log-sum-exp."""
    b, lq, hq, d = q.shape
    _, lk, hkv, _ = k.shape
    lib = build.library("flash_attention")
    bf16 = q.dtype == torch.bfloat16
    name = "flash_attention_bf16" if bf16 else "flash_attention"
    entry = lib.flash_attention_bf16 if bf16 else lib.flash_attention_f32
    o = torch.empty((b, lq, hq, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, lq, lk, hq, hkv, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *o.stride()[:3], int(causal),
            0 if window is None else window,
            0.0 if soft_cap is None else soft_cap, 1.0 / math.sqrt(d),
            stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err} "
            f"({lib.flash_attention_error_string(err).decode()}) for q "
            f"{tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}, "
            f"causal={causal}, soft_cap={soft_cap}, window={window}")
    LAUNCHES[name] += 1
    return o


def _launch_backward(kernel, q, k, v, do, lse, stats, outs, causal,
                     soft_cap, window, plan=None) -> None:
    """One launch of ``flash_attention_bwd_{kernel}_f32`` (``_bf16`` for
    bf16 operands): ``"dq"`` (outs = (dq,), of q's dtype) reads the
    forward's ``lse`` and writes the rows' lse' and delta into ``stats``
    (2, B, Hq, Lq); ``"dkdv"`` (outs = the f32 partial dK and dV, each
    (G, B, Lk, Hkv, D), or dk and dv of k's dtype when G = 1) reads them.
    Outputs contiguous; ``plan`` (default :func:`bwd_plan` of the shapes)
    gives the blocks."""
    b, lq, hq, d = q.shape
    _, lk, hkv, _ = k.shape
    plan = plan or bwd_plan(b, lq, lk, hq, hkv, d)
    lib = build.library("flash_attention_bwd")
    name = f"flash_attention_bwd_{kernel}"
    bf16 = q.dtype == torch.bfloat16
    ptrs = [t.data_ptr() for t in outs] + [None] * (2 - len(outs))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, f"{name}_bf16" if bf16 else f"{name}_f32")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), stats.data_ptr(), *ptrs, b, lq, lk, hq, hkv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3], int(causal), 0 if window is None else window,
            0.0 if soft_cap is None else soft_cap, 1.0 / math.sqrt(d),
            getattr(plan, f"{kernel}_blocks"), stream)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {err} "
            f"({lib.flash_attention_bwd_error_string(err).decode()}) for q "
            f"{tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}, "
            f"causal={causal}, soft_cap={soft_cap}, window={window}")
    BWD_LAUNCHES[f"{name}_bf16" if bf16 else name] += 1


def sum_partials_plain(part: torch.Tensor):
    """The sum kernel's function in plain PyTorch: (dk, dv), each the G
    heads' partials of ``part`` (2, G, B, Lk, Hkv, D) added in head order,
    as the kernel adds them (bitwise the same)."""
    dk, dv = part[0, 0].clone(), part[1, 0].clone()
    for i in range(1, part.shape[1]):
        dk += part[0, i]
        dv += part[1, i]
    return dk, dv


def _launch_sum(part, dk, dv, plan) -> None:
    """One launch of ``flash_attention_bwd_sum_f32`` (``_bf16`` for bf16
    dk and dv, rounded once): dk and dv, each the sum in head order of
    the G f32 partials in ``part`` (2, G, B, Lk, Hkv, D)."""
    lib = build.library("flash_attention_bwd")
    bf16 = dk.dtype == torch.bfloat16
    entry = lib.flash_attention_bwd_sum_bf16 if bf16 \
        else lib.flash_attention_bwd_sum_f32
    with torch.cuda.device(dk.device):
        stream = torch.cuda.current_stream(dk.device).cuda_stream
        err = entry(
            part.data_ptr(), dk.data_ptr(), dv.data_ptr(), dk.numel(),
            plan.group, plan.sum_blocks, stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention_bwd_sum kernel launch failed: CUDA error {err} "
            f"({lib.flash_attention_bwd_error_string(err).decode()}) for "
            f"partials {tuple(part.shape)}")
    BWD_LAUNCHES["flash_attention_bwd_sum_bf16" if bf16
                 else "flash_attention_bwd_sum"] += 1


def flash_attention_backward(q, k, v, lse, do, *, causal=True,
                             soft_cap=None, window=None):
    """(dq, dk, dv) of attention at ``do``, from the forward's ``lse``
    (B, Hq, Lq), each gradient of its operand's dtype (q, k, v and do all
    f32 or all bf16; lse f32).  On CUDA tensors one launch of each
    backward kernel of the dtype's route (dQ with the rows' statistics;
    the query heads' partial dK and dV; for G > 1 their sum; counted in
    ``BWD_LAUNCHES``); on CPU tensors
    :func:`flash_attention_backward_plain`.  D > 256 raises
    ``NotImplementedError``."""
    _check(q, k, v, causal, soft_cap, window)
    if do.dtype != q.dtype:
        raise ValueError(f"do is {do.dtype}, q {q.dtype}: the cotangent "
                         "takes the operands' dtype")
    if q.shape[-1] > MAX_BWD_D:
        raise NotImplementedError(WIDE_BWD)
    kw = dict(causal=causal, soft_cap=soft_cap, window=window)
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, lse, do, **kw)
    if do.stride(-1) != 1:
        do = do.contiguous()
    lse = lse.contiguous()
    b, lq, hq, d = q.shape
    plan = bwd_plan(b, lq, k.shape[1], hq, k.shape[2], d)
    stats = torch.empty((2, *lse.shape), dtype=torch.float32,
                        device=q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _launch_backward("dq", q, k, v, do, lse, stats, (dq,), plan=plan, **kw)
    if plan.group == 1:
        _launch_backward("dkdv", q, k, v, do, lse, stats, (dk, dv),
                         plan=plan, **kw)
        return dq, dk, dv
    part = torch.empty(plan.scratch, dtype=torch.float32, device=q.device)
    _launch_backward("dkdv", q, k, v, do, lse, stats, (part[0], part[1]),
                     plan=plan, **kw)
    _launch_sum(part, dk, dv, plan)
    return dq, dk, dv


class _FlashAttentionFn(torch.autograd.Function):
    """Attention with the kernels' gradient: the forward keeps (q, k, v,
    lse), the backward runs :func:`flash_attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, soft_cap, window):
        if q.device.type == "cpu":
            o, lse = _plain_forward(q, k, v, causal=causal, soft_cap=soft_cap,
                                    window=window, block_k=BLOCK_K)
        else:
            b, lq, hq, _ = q.shape
            lse = torch.empty((b, hq, lq), dtype=torch.float32,
                              device=q.device)
            o = _launch_forward(q, k, v, causal, soft_cap, window, lse)
        ctx.save_for_backward(q, k, v, lse)
        ctx.kw = dict(causal=causal, soft_cap=soft_cap, window=window)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, soft_cap: float | None = None,
                    window: int | None = None) -> torch.Tensor:
    """q: (B, Lq, Hq, D); k/v: (B, Lk, Hkv, D), all f32 or all bf16, head
    dim contiguous (other strides are read as they are) -> (B, Lq, Hq, D)
    of q's dtype.

    On CUDA tensors, one launch of the hand-written kernel's route for
    the dtype (counted in ``LAUNCHES``); on CPU tensors,
    :func:`flash_attention_plain`.  Under autograd, through
    ``_FlashAttentionFn`` (module docstring), whose backward runs the
    backward kernels of the dtype's route.  Raises
    ``ValueError`` for what the kernel cannot take: another dtype, mixed
    dtypes, Hq % Hkv != 0, causal with Lq > Lk.  Any head_dim: D > 256
    runs the kernel's wide-head route (D in chunks, 256 output columns a
    block), which has no backward: under autograd it raises
    ``NotImplementedError``.
    """
    _check(q, k, v, causal, soft_cap, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q.shape[-1] > MAX_BWD_D:
            raise NotImplementedError(WIDE_BWD)
        return _FlashAttentionFn.apply(q, k, v, causal, soft_cap, window)
    if q.device.type == "cpu":
        with torch.no_grad():
            return flash_attention_plain(q, k, v, causal=causal,
                                         soft_cap=soft_cap, window=window)
    return _launch_forward(q, k, v, causal, soft_cap, window)
