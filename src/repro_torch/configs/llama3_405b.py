"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 — GQA, 128k vocab.  [arXiv:2407.21783; unverified]

At full width it does not fit one card (1.6 TB of f32 parameters): the
port counts its parameters and runs its SMOKE configuration."""

from repro_torch.models.config import ModelConfig

ARCH_ID = "llama3-405b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="dense", n_layers=126, d_model=16384, n_heads=128,
    n_kv_heads=8, head_dim=128, d_ff=53248, vocab=128256, rope_theta=5e5)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=208, vocab=128, attn_impl="ref", remat=False)
