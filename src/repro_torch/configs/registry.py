"""Architecture registry: ``--arch <id>`` resolution, parameter counts and
model FLOPs (the counterpart of ``repro/configs/registry.py``).

Every architecture of the JAX package: the dense decoder family, the
ssm family (falcon-mamba-7b), the hybrid family (recurrentgemma-2b), the
encoder-decoder family (seamless-m4t-large-v2) and the MoE family
(qwen3-moe-30b-a3b, phi3.5-moe-42b-a6.6b).
"""

from __future__ import annotations

import importlib

from repro_torch.models import api
from repro_torch.models.base import Param, tree_size
from repro_torch.models.config import ModelConfig

_MODULES = ["qwen25_3b", "starcoder2_3b", "starcoder2_7b", "llama3_405b",
            "llava_next_34b", "falcon_mamba", "recurrentgemma_2b",
            "seamless_m4t", "qwen3_moe", "phi35_moe"]

_TABLE: dict | None = None


def _table() -> dict:
    global _TABLE
    if _TABLE is None:
        mods = [importlib.import_module(f"repro_torch.configs.{m}")
                for m in _MODULES]
        _TABLE = {mod.ARCH_ID: mod for mod in mods}
    return _TABLE


def archs() -> list[str]:
    """The ids the port runs."""
    return list(_table())


def get(arch_id: str):
    """The config module (``ARCH_ID``, ``CONFIG``, ``SMOKE``) of an id."""
    table = _table()
    if arch_id not in table:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(table)}")
    return table[arch_id]


def count_params(cfg: ModelConfig) -> int:
    """Exact parameter count from the declaration tree (no allocation)."""
    return tree_size(api.params(cfg))


def _leaves(tree):
    if isinstance(tree, Param):
        yield tree
        return
    for v in tree.values():
        yield from _leaves(v)


def count_active_params(cfg: ModelConfig) -> int:
    """Parameters active per token: a leaf with an experts axis
    (``Param.experts``) and three or more dims counts ``top_k /
    n_experts`` of its elements, rounded down, as JAX's count does
    (``repro/configs/registry.py:67``; the stacked router is such a
    leaf there too)."""
    total = 0
    for p in _leaves(api.params(cfg)):
        n = tree_size(p)
        if p.experts and len(p.shape) >= 3:
            n = n * cfg.top_k // max(cfg.n_experts, 1)
        total += n
    return total


MODEL_FLOP_KINDS = ("train", "prefill", "decode")


def model_flops(cfg: ModelConfig, kind: str, batch: int, seq: int) -> float:
    """Model FLOPs of one step (``repro/configs/registry.py:107``, which
    reads ``kind``, ``batch`` and ``seq`` from a ``ShapePlan``): 6 N D to
    train, 2 N D to infer, N the active parameters and D the tokens
    (``batch`` x ``seq``; one a sequence to decode).  The
    encoder-decoder counts its encoder, decoder and embedding."""
    if kind not in MODEL_FLOP_KINDS:
        raise ValueError(f"kind={kind!r} must be one of {MODEL_FLOP_KINDS}")
    n = count_active_params(cfg)
    if cfg.family == "encdec":
        tree = api.params(cfg)
        n_enc = tree_size(tree["enc_blocks"])
        n_dec = tree_size(tree["dec_blocks"])
        n_emb = tree_size(tree["tok"])
        if kind == "train":
            return 6.0 * batch * seq * (n_enc + n_dec + n_emb)
        if kind == "prefill":
            return 2.0 * batch * seq * (n_enc + n_dec + n_emb)
        return 2.0 * batch * (n_dec + n_emb)
    tokens = batch * (seq if kind != "decode" else 1)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens
