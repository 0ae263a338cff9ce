"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct; hf]"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "phi3.5-moe-42b-a6.6b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="moe", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, head_dim=128, d_ff=6400, moe_dff=6400, n_experts=16,
    top_k=2, vocab=32064, rope_theta=1e4, norm="layernorm")

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, moe_dff=96, n_experts=4, top_k=2, vocab=128, attn_impl="ref",
    remat=False)
