"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7, MoE every other.

A copy of ``repro/configs/jamba15_large_398b.py``.

72 layers = 9 super-blocks of 8, d_model=8192, 64 heads (kv=8), d_ff=24576,
vocab=65536, MoE 16 experts top-2 [arXiv:2403.19887]. Each super-block has
one attention layer (index 4) and seven Mamba layers; MoE replaces the MLP
on every odd layer.
"""
from repro_torch.models.config import ModelConfig

_PATTERN = ("mamba_dense", "mamba_moe", "mamba_dense", "mamba_moe",
            "attn", "mamba_moe", "mamba_dense", "mamba_moe")

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    schedule=((_PATTERN, 9),),
    n_experts=16,
    moe_top_k=2,
    moe_d_ff=24576,
    mamba_expand=2,
    mamba_state=16,
    mamba_conv=4,
    param_dtype="bfloat16",
    train_microbatch=64,
    attn_sp=True,
    decode_layout="decode_tp",
)

SMOKE = CONFIG.reduced()
