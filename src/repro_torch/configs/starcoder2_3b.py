"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE.  [arXiv:2402.19173; hf]"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "starcoder2-3b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="dense", n_layers=30, d_model=3072, n_heads=24,
    n_kv_heads=2, head_dim=128, d_ff=12288, vocab=49152, qkv_bias=True,
    norm="layernorm", mlp="gelu", rope_theta=1e5)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, head_dim=12,
    d_ff=192, vocab=128, attn_impl="ref", remat=False)
