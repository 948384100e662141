"""gemma3-27b [dense] — 5:1 local:global attention, 128k context.

A copy of ``repro/configs/gemma3_27b.py``. 62 layers, d_model=5376, 32 heads
(GQA kv=16), d_ff=21504, vocab=262144 [hf:google/gemma-3-27b]. Sliding window
1024 on local layers; qk-norm; tied embeddings. 62 = 10 x (5 local + 1
global) + 2 local.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    schedule=(
        (("local", "local", "local", "local", "local", "attn"), 10),
        (("local", "local"), 1),
    ),
    sliding_window=1024,
    use_qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
    train_microbatch=32,
)

SMOKE = CONFIG.reduced(sliding_window=8)
