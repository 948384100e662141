"""command-r-plus-104b [dense] — GQA, no biases.

A copy of ``repro/configs/command_r_plus_104b.py``.

64 layers, d_model=12288, 96 heads (GQA kv=8), d_ff=33792, vocab=256000
[hf:CohereForAI/c4ai-command-r-plus]. The widest d_model of the assigned
pool — the DCT basis here is 12288x12288 (one per device, bf16 = 302 MB,
still far below Dion-style per-layer projections; see DESIGN.md §7.3).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    schedule=((("attn",), 64),),
    rope_theta=75_000_000.0,
    param_dtype="bfloat16",
    train_microbatch=64,     # §Perf iter-4
    attn_sp=True,            # §Perf iter-1: kv=8 doesn't divide tp
    decode_layout="decode_tp",  # §Perf iter-6
)

SMOKE = CONFIG.reduced()
