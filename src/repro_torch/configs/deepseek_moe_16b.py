"""deepseek-moe-16b [moe] — fine-grained experts, 2 shared + 64 routed top-6.

A copy of ``repro/configs/deepseek_moe_16b.py``.

28 layers (first dense), d_model=2048, 16 heads (kv=16), expert hidden 1408,
vocab=102400 [arXiv:2401.06066]. The first layer is the published dense
layer (d_ff=10944); shared experts total 2x1408=2816 hidden.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,                     # dense layer 0
    vocab_size=102400,
    schedule=((("attn",), 1), (("attn_moe",), 27)),
    n_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1408,
    shared_d_ff=2816,
    param_dtype="float32",
    train_microbatch=64,
)

SMOKE = CONFIG.reduced(schedule=((("attn",), 1), (("attn_moe",), 1)))
