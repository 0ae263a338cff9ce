"""seamless-m4t-large-v2 [encdec] — 24 encoder + 24 decoder layers,
d_model=1024 16H (kv=16 -> MHA, head_dim 64) d_ff=8192 (gelu, LayerNorm)
vocab=256206 — encoder-decoder, multimodal.

"24L" = 24 encoder + 24 decoder layers (the HF text encoder / decoder of
seamless-m4t-v2-large).  The speech frontend is a stub, as in the JAX
package: the batch carries ``src``, precomputed frame embeddings (B, Ls,
d_model) in the params' dtype.  [arXiv:2308.11596; hf]
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "seamless-m4t-large-v2"

CONFIG = ModelConfig(
    name=ARCH_ID, family="encdec", n_layers=48, enc_layers=24,
    dec_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab=256206, norm="layernorm", mlp="gelu",
    frontend="audio")

SMOKE = CONFIG.replace(
    n_layers=4, enc_layers=2, dec_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=128, vocab=128, attn_impl="ref",
    remat=False)
