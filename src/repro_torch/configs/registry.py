"""Architecture registry: ``--arch <id>`` resolution and parameter counts
(the counterpart of ``repro/configs/registry.py``).

Every architecture of the JAX package: the dense decoder family, the
ssm family (falcon-mamba-7b), the hybrid family (recurrentgemma-2b), the
encoder-decoder family (seamless-m4t-large-v2) and the MoE family
(qwen3-moe-30b-a3b, phi3.5-moe-42b-a6.6b).
"""

from __future__ import annotations

import importlib

from repro_torch.models import api
from repro_torch.models.base import tree_size
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
