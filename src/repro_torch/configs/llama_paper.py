"""The paper's own pre-training models: Llama 30M / 350M / 800M / 1.3B.

A copy of ``repro/configs/llama_paper.py``. Sized to the paper's reported
(params, d_model) pairs — §3: 350M (d=1024), 800M (d=2048), 1.3B (d=2048),
plus the 30M (d=640) model used for the projection-error study (App. F).
Sequence length 512, C4-style next-token objective (synthetic data here).
"""
from repro_torch.models.config import ModelConfig


def _llama(name, layers, d, heads, d_ff, vocab=32000):
    return ModelConfig(
        name=name,
        family="dense",
        d_model=d,
        n_heads=heads,
        n_kv_heads=heads,
        d_ff=d_ff,
        vocab_size=vocab,
        schedule=((("attn",), layers),),
        rope_theta=1e4,
        param_dtype="float32",
        q_chunk=512,
        kv_chunk=512,
    )


LLAMA_30M = _llama("llama-30m", 6, 640, 10, 1728)
LLAMA_350M = _llama("llama-350m", 24, 1024, 16, 2816)
LLAMA_800M = _llama("llama-800m", 16, 2048, 16, 5504)
LLAMA_1_3B = _llama("llama-1.3b", 24, 2048, 16, 5504)

CONFIG = LLAMA_350M
SMOKE = CONFIG.reduced()
