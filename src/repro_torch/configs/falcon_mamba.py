"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16, mamba1 architecture.  [arXiv:2410.05355; unverified]"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "falcon-mamba-7b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="ssm", n_layers=64, d_model=4096, n_heads=1,
    n_kv_heads=1, d_ff=0, vocab=65024, ssm_state=16, d_conv=4,
    dt_rank=256, expand=2, scan_chunk=256)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, vocab=128, ssm_state=8, dt_rank=8,
    scan_chunk=16, remat=False)
