"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention (window 2048), pattern
(rec, rec, att) = 1:2 attention:recurrent.  [arXiv:2402.19427; hf]"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "recurrentgemma-2b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="hybrid", n_layers=26, d_model=2560, n_heads=10,
    n_kv_heads=1, head_dim=256, d_ff=7680, vocab=256000, mlp="geglu",
    window=2048, block_pattern=("rec", "rec", "att"), lru_width=2560,
    logits_soft_cap=30.0, rope_theta=1e4,
    tie_embeddings=True)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=192, lru_width=64, vocab=128, window=8, attn_impl="ref",
    remat=False)
