"""deepseek-v3-671b [moe] — MLA + 1 shared + 256 routed top-8 + MTP.

A copy of ``repro/configs/deepseek_v3_671b.py``.

61 layers (first 3 dense), d_model=7168, 128 MLA heads, vocab=129280, MoE
256 experts top-8 with expert hidden 2048 [arXiv:2412.19437]. The brief's
``d_ff=2048`` is the routed-expert hidden size; the three dense layers use
the model's published dense d_ff=18432. MLA dims are the published ones
(q_lora 1536, kv_lora 512, nope 128, rope 64, v 128). MTP enabled.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,                     # dense layers (3)
    vocab_size=129280,
    schedule=((("mla_dense",), 3), (("mla_moe",), 58)),
    n_experts=256,
    n_shared_experts=1,
    moe_top_k=8,
    moe_d_ff=2048,                  # per the brief: routed expert hidden
    shared_d_ff=2048,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    mtp=True,
    param_dtype="bfloat16",
    train_microbatch=64,     # §Perf iter-4: halves FSDP regather/grad-AR
    decode_layout="decode_tp",  # §Perf iter-6
)

SMOKE = CONFIG.reduced(schedule=((("mla_dense",), 1), (("mla_moe",), 1)))
