"""llama-3.2-vision-90b [vlm] — cross-attention image layers every 5th.

A copy of ``repro/configs/llama32_vision_90b.py``.

100 layers, d_model=8192, 64 heads (GQA kv=8), d_ff=28672, vocab=128256
[hf:meta-llama/Llama-3.2-*-Vision]. The vision tower is stubbed: the batch
supplies precomputed (B, n_image_tokens, d_model) patch embeddings
(``batch["image_embeds"]``).
Every 5th layer is a gated cross-attention block (tanh-gated attn + MLP,
the Llama-3.2 adapter recipe).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    schedule=((("attn", "attn", "attn", "attn", "cross"), 20),),
    n_image_tokens=6400,            # 4 tiles x 1600 patches (stub frontend)
    rope_theta=500000.0,
    param_dtype="bfloat16",
    train_microbatch=64,     # §Perf iter-4
    attn_sp=True,            # §Perf iter-1: kv=8 doesn't divide tp
    decode_layout="decode_tp",  # §Perf iter-6
)

SMOKE = CONFIG.reduced()
