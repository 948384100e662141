"""``--arch <id>`` lookup.

Ported: the paper's four llama models and the dense GQA configurations of
the JAX registry: gemma3-27b (sliding-window local layers, qk-norm),
qwen2.5-32b (qkv bias, group 5), phi3-mini-3.8b (head dim 96, plain MHA) and
command-r-plus-104b (group 12); the DeepSeek MoE family: deepseek-moe-16b
(``attn_moe``: 64 routed experts top-6 and 2 shared) and deepseek-v3-671b
(MLA, 256 experts top-8, the MTP head); and the recurrent families:
jamba-1.5-large-398b (Mamba + attention + MoE, no shared experts) and
rwkv6-1.6b (RWKV-6); and the encoder-decoder and cross-attention families:
whisper-large-v3 (32 encoder and 32 decoder layers over stub audio frames)
and llama-3.2-vision-90b (a gated cross-attention layer every fifth, over
stub patch embeddings). That is every architecture of
``repro.configs.registry``. Unlike the JAX registry, ``smoke=True`` works for
the llamas too: it returns the architecture's ``reduced()`` config (d=128,
one layer, vocab 512); the other archs' is their module's ``SMOKE``, as in
the JAX registry.
"""
from __future__ import annotations

from . import (command_r_plus_104b, deepseek_moe_16b, deepseek_v3_671b,
               gemma3_27b, jamba15_large_398b, llama32_vision_90b,
               llama_paper, phi3_mini_3p8b, qwen25_32b, rwkv6_1p6b,
               whisper_large_v3)

_MODULES = {
    "gemma3-27b": gemma3_27b,
    "qwen2.5-32b": qwen25_32b,
    "phi3-mini-3.8b": phi3_mini_3p8b,
    "command-r-plus-104b": command_r_plus_104b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "jamba-1.5-large-398b": jamba15_large_398b,
    "rwkv6-1.6b": rwkv6_1p6b,
    "whisper-large-v3": whisper_large_v3,
    "llama-3.2-vision-90b": llama32_vision_90b,
}
ARCHS = {
    "llama-30m": llama_paper.LLAMA_30M,
    "llama-350m": llama_paper.LLAMA_350M,
    "llama-800m": llama_paper.LLAMA_800M,
    "llama-1.3b": llama_paper.LLAMA_1_3B,
    **{name: mod.CONFIG for name, mod in _MODULES.items()},
}
SMOKES = {name: cfg.reduced() for name, cfg in ARCHS.items()}
SMOKES.update({name: mod.SMOKE for name, mod in _MODULES.items()})

#: architectures of the JAX registry this package does not build yet: none
NOT_YET_PORTED: tuple[str, ...] = ()


def get_config(arch: str, smoke: bool = False):
    table = SMOKES if smoke else ARCHS
    if arch not in table:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(table)}")
    return table[arch]


def list_archs() -> list[str]:
    return sorted(ARCHS)
