"""starcoder2-7b [dense] — 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152 — GQA, RoPE, LayerNorm+bias, GeLU MLP.  [arXiv:2402.19173; hf]"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "starcoder2-7b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="dense", n_layers=32, d_model=4608, n_heads=36,
    n_kv_heads=4, head_dim=128, d_ff=18432, vocab=49152, qkv_bias=True,
    norm="layernorm", mlp="gelu", rope_theta=1e5)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=72, n_heads=6, n_kv_heads=2, head_dim=12,
    d_ff=288, vocab=128, attn_impl="ref", remat=False)
