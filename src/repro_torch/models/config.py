"""ModelConfig: one dataclass describing every architecture of ``repro``.

A copy of ``repro/models/config.py`` (the port imports nothing of ``repro``).
This package builds every block kind and family of it
(``models.transformer.PORTED_KINDS``); the fields of the JAX package's
meshes and layouts are kept so configurations read the same in both.

``schedule`` expresses the layer layout as segments of repeating
"super-blocks": ``((pattern, repeats), ...)`` where ``pattern`` is a tuple of
block kinds. Each segment's parameters are stacked over its repeats;
interleavings (gemma3 5 local : 1 global, jamba
1 attn : 7 mamba with MoE every other layer) are expressed inside the
pattern, exactly as deployed.

Block kinds:
  attn        causal GQA self-attention + dense SwiGLU
  local       as `attn` but sliding-window
  attn_moe    causal GQA self-attention + MoE FFN
  mla_dense   DeepSeek MLA attention + dense SwiGLU
  mla_moe     DeepSeek MLA attention + (shared + routed) MoE
  mamba_dense Mamba SSM mixer + dense SwiGLU
  mamba_moe   Mamba SSM mixer + MoE FFN
  rwkv        RWKV-6 time-mix + channel-mix
  cross       cross-attention to stub image embeddings + dense SwiGLU (VLM)
  enc         bidirectional attention + GELU MLP (whisper encoder)
  dec         causal self-attn + cross-attn(encoder) + GELU MLP
"""
from __future__ import annotations

import dataclasses
from typing import Optional

Schedule = tuple[tuple[tuple[str, ...], int], ...]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|hybrid|ssm|encdec|vlm
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    schedule: Schedule
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    use_qk_norm: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    sliding_window: int = 4096       # for 'local' blocks
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                # routed expert hidden size
    shared_d_ff: int = 0             # shared expert hidden size
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # MLA (deepseek-v3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False                # multi-token-prediction extra head
    # Mamba (jamba)
    mamba_expand: int = 2
    mamba_state: int = 16
    mamba_conv: int = 4
    mamba_dt_rank: int = 0           # 0 -> d_model // 16
    # RWKV-6
    rwkv_head_size: int = 64
    rwkv_decay_lora: int = 64
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500          # fixed audio-frame count (stub frontend)
    # VLM
    n_image_tokens: int = 0
    # precision
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # attention chunking (blockwise flash-style)
    q_chunk: int = 512
    kv_chunk: int = 1024
    remat: bool = True
    # gradient-accumulation microbatch (rows of the global batch per inner
    # step; 0 = whole batch in one shot). Chosen per arch so activations fit.
    train_microbatch: int = 0
    # sequence-parallel attention over the `model` axis (shard_map; §Perf
    # iter-1). Wins when head counts don't divide tp (qwen 40q/8kv);
    # loses when they do (deepseek 128) — set per arch from measurements.
    attn_sp: bool = False
    # parameter layout policy: "fsdp_tp" | "pure_dp" (§Perf iter-5 —
    # sub-2B archs replicate params and data-parallelize all 256 chips)
    layout: str = "fsdp_tp"
    # decode-shape layout: "decode_tp" (§Perf iter-6) puts every matrix
    # column/row-parallel over the combined (dp x tp) axes so a decode
    # step does shard-local matmuls + one activation psum per block
    # instead of re-gathering FSDP weight shards per token
    decode_layout: str = "fsdp_tp"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_layers(self) -> int:
        return sum(len(p) * r for p, r in self.schedule)

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or max(1, self.d_model // 16)

    @property
    def rwkv_n_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    def block_kinds(self) -> tuple[str, ...]:
        out = []
        for pattern, _ in self.schedule:
            out.extend(pattern)
        return tuple(dict.fromkeys(out))

    @property
    def is_attention_free(self) -> bool:
        return all(k in ("rwkv", "mamba_dense", "mamba_moe")
                   for k in self.block_kinds())

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs: SSM / hybrid / sliding-window-dominated."""
        kinds = self.block_kinds()
        if any(k in ("rwkv", "mamba_dense", "mamba_moe") for k in kinds):
            return True
        return "local" in kinds           # gemma3-style 5:1 local:global

    def reduced(self, **overrides) -> "ModelConfig":
        """A small same-family config for CPU smoke tests."""
        def shrink_schedule(sched: Schedule) -> Schedule:
            return tuple((pattern, min(r, 1)) for pattern, r in sched)

        base = dict(
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            schedule=shrink_schedule(self.schedule),
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            moe_d_ff=64 if self.moe_d_ff else 0,
            shared_d_ff=64 if self.shared_d_ff else 0,
            q_lora_rank=64 if self.q_lora_rank else 0,
            kv_lora_rank=64 if self.kv_lora_rank else 0,
            qk_nope_dim=32 if self.qk_nope_dim else 0,
            qk_rope_dim=16 if self.qk_rope_dim else 0,
            v_head_dim=32 if self.v_head_dim else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=16 if self.encoder_layers else self.encoder_seq,
            n_image_tokens=8 if self.n_image_tokens else 0,
            capacity_factor=8.0,   # drop-free routing: smoke tests compare
                                   # forward vs prefill+decode exactly
            sliding_window=8,
            q_chunk=8,
            kv_chunk=8,
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
            mamba_dt_rank=8 if "mamba_dense" in self.block_kinds()
                          or "mamba_moe" in self.block_kinds() else 0,
            rwkv_head_size=32,
            rwkv_decay_lora=8,
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)
