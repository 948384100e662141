"""qwen2.5-32b [dense] — GQA with QKV bias.

A copy of ``repro/configs/qwen25_32b.py``.

64 layers, d_model=5120, 40 heads (GQA kv=8), d_ff=27648, vocab=152064
[hf:Qwen/Qwen2.5-32B].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    schedule=((("attn",), 64),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
    train_microbatch=32,
    attn_sp=True,            # §Perf iter-1: 40q/8kv heads don't divide tp
    decode_layout="decode_tp",  # §Perf iter-6
)

SMOKE = CONFIG.reduced()
