"""qwen2.5-3b [dense] — 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 — GQA, QKV bias.  [hf:Qwen/Qwen2.5-3B; hf]"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen2.5-3b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="dense", n_layers=36, d_model=2048, n_heads=16,
    n_kv_heads=2, head_dim=128, d_ff=11008, vocab=151936, qkv_bias=True,
    rope_theta=1e6)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=192, vocab=128, attn_impl="ref", remat=False)
