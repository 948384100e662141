"""Deterministic synthetic LM data (no external corpora).

A Zipf-distributed, Markov-flavored token stream, as in
``repro/data/synthetic.py``: deterministic in (seed, step), and learnable
(a next token depends on the previous one), so the loss falls.

The random numbers come from a ``torch.Generator`` seeded with
``(seed, step)`` on the target device: the same construction as the JAX
package, but a different stream, so the two packages give different batches
for the same seed. Tests that compare them feed both the same numpy batches.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.devices import resolve_device


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.1
    markov_shift: int = 7

    def _zipf_sample(self, gen: torch.Generator, shape, device):
        """Inverse-CDF Zipf over [2, vocab) (0/1 reserved: pad/bos). The CDF
        is summed on the CPU, in order: on a CUDA device the cumsum of one
        long vector (a decoupled look-back scan) can add in another order
        from one call to the next, and move a token of the batch."""
        v = self.vocab_size - 2
        ranks = torch.arange(1, v + 1, dtype=torch.float32)
        w = ranks ** (-self.zipf_a)
        cdf = (torch.cumsum(w, 0) / w.sum()).to(device)
        u = torch.rand(shape, generator=gen, device=device)
        idx = torch.searchsorted(cdf, u).clamp_max(v - 1)
        return idx + 2

    def batch(self, step: int, device=None) -> dict:
        """``{"tokens", "targets"}`` (B, S) int64 for one global step, on
        ``device`` (None: the card; ``resolve_device``)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(
            self.seed * 1_000_003 + step)
        b, s = self.global_batch, self.seq_len
        base = self._zipf_sample(gen, (b, s + 1), dev)
        # Markov flavor: token_t depends on token_{t-1} (learnable signal)
        prev = torch.roll(base, 1, dims=1)
        mixed = torch.where(
            (prev + base) % 3 == 0,
            (prev * self.markov_shift + 11) % (self.vocab_size - 2) + 2,
            base,
        )
        return {"tokens": mixed[:, :-1], "targets": mixed[:, 1:]}


def make_batch_fn(cfg, seq_len: int, global_batch: int, seed: int = 0,
                  device=None):
    """``step -> batch`` on ``device`` (None: the card). Only token inputs
    are ported (no audio-frame or image-embedding stubs)."""
    if cfg.encoder_layers or cfg.n_image_tokens:
        raise NotImplementedError("synthetic frames / image embeddings are "
                                  "not yet ported to repro_torch")
    device = resolve_device(device)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq_len,
                     global_batch=global_batch, seed=seed)

    def fn(step: int) -> dict:
        return ds.batch(step, device)

    return fn
