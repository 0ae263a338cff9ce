"""llava-next-34b [vlm] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling.  The vision frontend is a stub: a caller
passes precomputed patch embeddings as ``batch["vision"]`` (anyres: 1 base
tile + 2x2 grid of 336px tiles @ 14px patches = 2880 tokens), projected by
``vision_proj`` and prepended to the text.  [hf:llava-hf/llava-v1.6-34b-hf;
unverified]
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "llava-next-34b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="dense", n_layers=60, d_model=7168, n_heads=56,
    n_kv_heads=8, head_dim=128, d_ff=20480, vocab=64000, rope_theta=5e6,
    frontend="vision", n_frontend_tokens=2880)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=56, n_heads=4, n_kv_heads=2, head_dim=14,
    d_ff=224, vocab=128, n_frontend_tokens=8, attn_impl="ref", remat=False)
