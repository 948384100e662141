"""whisper-large-v3 [audio] — encoder-decoder, conv frontend stubbed.

A copy of ``repro/configs/whisper_large_v3.py``.

32 encoder + 32 decoder layers, d_model=1280, 20 heads (kv=20), d_ff=5120,
vocab=51866 [arXiv:2212.04356]. The batch supplies precomputed
(B, 1500, d) frame embeddings (``batch["frames"]``) in place of the
mel+conv frontend (a stub, as in the JAX package). Decoder positions use RoPE instead of Whisper's learned absolute
embeddings so the decoder is shape-polymorphic to the 32k decode shape
(deviation recorded in DESIGN.md).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    schedule=((("dec",), 32),),
    encoder_layers=32,
    encoder_seq=1500,
    norm_eps=1e-5,
    param_dtype="float32",
    train_microbatch=64,
    layout="pure_dp",        # §Perf iter-5: 1.5B fits replicated
)

SMOKE = CONFIG.reduced(schedule=((("dec",), 2),))
