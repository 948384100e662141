"""rwkv6-1.6b "Finch" [ssm] — attention-free, data-dependent decay.

A copy of ``repro/configs/rwkv6_1p6b.py``.

24 layers, d_model=2048, d_ff=7168, vocab=65536 [arXiv:2404.05892].
Head size 64 (32 WKV heads), decay LoRA rank 64. Constant-size state makes
every decode shape O(1) per token.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    d_model=2048,
    n_heads=32,                     # = d_model / rwkv_head_size
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    schedule=((("rwkv",), 24),),
    rwkv_head_size=64,
    rwkv_decay_lora=64,
    norm_eps=1e-5,
    param_dtype="float32",
    train_microbatch=64,
    layout="pure_dp",
)

SMOKE = CONFIG.reduced(schedule=((("rwkv",), 2),))
