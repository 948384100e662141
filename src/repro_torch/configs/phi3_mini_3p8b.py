"""phi3-mini-3.8b [dense] — RoPE + SwiGLU + (degenerate) GQA.

A copy of ``repro/configs/phi3_mini_3p8b.py``.

32 layers, d_model=3072, 32 heads (kv=32 — plain MHA), d_ff=8192,
vocab=32064 [arXiv:2404.14219].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    schedule=((("attn",), 32),),
    param_dtype="float32",
    train_microbatch=64,
)

SMOKE = CONFIG.reduced()
