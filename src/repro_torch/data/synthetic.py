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


def stub_inputs(cfg, batch: int, gen: torch.Generator, device) -> dict:
    """The stub modality frontends' inputs of ``batch`` rows where the
    config has them, as the JAX package makes them: ``frames`` (batch,
    encoder_seq, d) for an encoder-decoder and ``image_embeds`` (batch,
    n_image_tokens, d) for a VLM, each 0.02 * N(0, 1) drawn from ``gen``
    and cast to the compute dtype."""
    cdt = getattr(torch, cfg.compute_dtype)
    lengths = {"frames": cfg.encoder_seq if cfg.encoder_layers else 0,
               "image_embeds": cfg.n_image_tokens}
    return {name: 0.02 * torch.randn((batch, n, cfg.d_model), generator=gen,
                                     device=device).to(cdt)
            for name, n in lengths.items() if n}


def make_batch_fn(cfg, seq_len: int, global_batch: int, seed: int = 0,
                  device=None):
    """``step -> batch`` on ``device`` (None: the card), with
    ``stub_inputs`` where the config has them, deterministic in (seed,
    step). The stubs come from another stream than the tokens: a
    ``torch.Generator`` seeded with ``(seed + 1, step)`` (the JAX package
    folds the step into ``PRNGKey(seed + 1)``; the numbers differ)."""
    device = resolve_device(device)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq_len,
                     global_batch=global_batch, seed=seed)

    def fn(step: int) -> dict:
        gen = torch.Generator(device=device).manual_seed(
            (seed + 1) * 1_000_003 + step)
        return {**ds.batch(step, device),
                **stub_inputs(cfg, global_batch, gen, device)}

    return fn
