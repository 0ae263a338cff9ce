"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) d_ff=768
(per expert) vocab=151936, MoE 128 experts top-8.  head_dim=128 per the HF
config (q/k projections are 32*128 > d_model).  [hf:Qwen/Qwen3-30B-A3B; hf]"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen3-moe-30b-a3b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="moe", n_layers=48, d_model=2048, n_heads=32,
    n_kv_heads=4, head_dim=128, d_ff=768, moe_dff=768, n_experts=128,
    top_k=8, vocab=151936, rope_theta=1e6)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=48, moe_dff=48, n_experts=8, top_k=2, vocab=128, attn_impl="ref",
    remat=False)
