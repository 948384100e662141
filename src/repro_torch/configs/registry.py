"""``--arch <id>`` lookup.

The paper's four llama models and gemma3-27b (sliding-window local layers,
GQA, qk-norm) are ported. Every other architecture of
``repro.configs.registry`` raises "not yet ported". Unlike the JAX
registry, ``smoke=True`` works for the llamas too: it returns the
architecture's ``reduced()`` config (d=128, one layer, vocab 512);
gemma3-27b's is its module's ``SMOKE``, as in the JAX registry.
"""
from __future__ import annotations

from . import gemma3_27b, llama_paper

ARCHS = {
    "llama-30m": llama_paper.LLAMA_30M,
    "llama-350m": llama_paper.LLAMA_350M,
    "llama-800m": llama_paper.LLAMA_800M,
    "llama-1.3b": llama_paper.LLAMA_1_3B,
    "gemma3-27b": gemma3_27b.CONFIG,
}
SMOKES = {name: cfg.reduced() for name, cfg in ARCHS.items()}
SMOKES["gemma3-27b"] = gemma3_27b.SMOKE

#: architectures of the JAX registry this package does not build yet
NOT_YET_PORTED = (
    "whisper-large-v3", "llama-3.2-vision-90b", "deepseek-v3-671b",
    "deepseek-moe-16b", "jamba-1.5-large-398b", "rwkv6-1.6b", "qwen2.5-32b",
    "phi3-mini-3.8b", "command-r-plus-104b",
)


def get_config(arch: str, smoke: bool = False):
    if arch in NOT_YET_PORTED:
        raise NotImplementedError(f"arch {arch!r} is not yet ported to "
                                  f"repro_torch; have {sorted(ARCHS)}")
    table = SMOKES if smoke else ARCHS
    if arch not in table:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(table)}")
    return table[arch]


def list_archs() -> list[str]:
    return sorted(ARCHS)
