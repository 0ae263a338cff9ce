"""Model configuration shared by every architecture family (the
counterpart of ``repro/models/config.py``, with the same fields).

The port runs float32 and bfloat16 (``dtype``: bf16 LM inference and
training, where the norms' scales and the scan states stay f32 as in JAX;
the trainer's entry point forces f32 as JAX's does, and bf16 training
runs through ``distributed.steps.make_train_step`` on bf16 params), and
its attention implementations are
``"flash"`` (the hand-written CUDA kernel of ``kernels/flash_attention.py``
on a CUDA tensor, its plain PyTorch version on a CPU tensor; the JAX
``"pallas"``), ``"chunked"`` and ``"ref"``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")
ATTN_IMPLS = ("flash", "chunked", "ref")
DTYPES = ("float32", "bfloat16")


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"      # dense | moe | ssm | hybrid | encdec
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 1024
    vocab: int = 1024
    head_dim: int | None = None
    qkv_bias: bool = False
    norm: str = "rmsnorm"      # rmsnorm | layernorm
    mlp: str = "swiglu"        # swiglu | geglu | gelu
    rope_theta: float = 1e4
    logits_soft_cap: float | None = None
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dff: int = 0
    capacity_factor: float = 1.25
    shared_expert_dff: int = 0     # dense expert alongside routed ones

    # SSM (mamba1)
    ssm_state: int = 0
    d_conv: int = 4
    dt_rank: int = 0
    expand: int = 2
    scan_chunk: int = 256

    # hybrid (RG-LRU)
    window: int | None = None      # local attention window
    block_pattern: tuple = ()      # e.g. ("rec", "rec", "att")
    lru_width: int = 0

    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0

    # modality frontend stub
    frontend: str | None = None    # vision | audio
    n_frontend_tokens: int = 0

    # execution knobs
    dtype: str = "float32"
    attn_impl: str = "flash"       # flash | chunked | ref
    attn_chunk: int = 1024
    remat: bool = True             # checkpoint each dense block under grad
    unroll_layers: bool = False    # the port's layer loop is always unrolled
    moe_impl: str = "gmm"          # gmm (capacity-grouped matmul)

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"family={self.family!r}; choose from "
                             f"{FAMILIES}")
        if self.dtype not in DTYPES:
            raise ValueError(
                f"dtype={self.dtype!r}: the port runs {' and '.join(DTYPES)}"
                " (ROADMAP Queue 1 item 2g)")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl={self.attn_impl!r}; choose from "
                             f"{ATTN_IMPLS}")
        if self.family == "moe":
            if not self.n_experts >= self.top_k >= 1 or self.moe_dff <= 0:
                raise ValueError(
                    f"moe: n_experts={self.n_experts}, top_k={self.top_k}, "
                    f"moe_dff={self.moe_dff}; want n_experts >= top_k >= 1 "
                    "and moe_dff > 0")
            if self.moe_impl != "gmm":
                raise ValueError(f"moe_impl={self.moe_impl!r}: the port "
                                 "runs 'gmm' (the capacity-grouped matmul)")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Approximate parameter count (``repro/models/config.py``'s, for
        MODEL_FLOPS); ``configs.registry.count_params`` is the exact one."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            din, s, r = self.d_inner, self.ssm_state, self.dt_rank
            per = (d * 2 * din + self.d_conv * din + din * (r + 2 * s)
                   + r * din + din * s + din + din * d)
            return self.n_layers * per + emb
        att = d * self.n_heads * self.hd + 2 * d * self.n_kv_heads * self.hd \
            + self.n_heads * self.hd * d
        if self.family == "moe":
            ffn = self.n_experts * 3 * d * self.moe_dff + d * self.n_experts \
                + 3 * d * self.shared_expert_dff
        elif self.mlp == "swiglu":
            ffn = 3 * d * self.d_ff
        else:
            ffn = 2 * d * self.d_ff
        if self.family == "hybrid":
            n_att = sum(1 for i in range(self.n_layers)
                        if self.pattern_at(i) == "att")
            n_rec = self.n_layers - n_att
            w = self.lru_width or d
            rec = 2 * d * w + w * d + self.d_conv * w + 3 * w * w + 2 * w
            return n_att * (att + ffn) + n_rec * (rec + ffn) + emb
        if self.family == "encdec":
            enc = self.enc_layers * (att + ffn)
            dec = self.dec_layers * (2 * att + ffn)   # self + cross
            return enc + dec + emb
        return self.n_layers * (att + ffn) + emb

    def pattern_at(self, i: int) -> str:
        if not self.block_pattern:
            return "att"
        return self.block_pattern[i % len(self.block_pattern)]
