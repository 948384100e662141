"""Sessions, requests, and per-sequence sampling state.

The serving engine is multi-tenant: every generation is a
:class:`Request` carrying its own prompt, token budget, stop condition
and :class:`SamplingParams`. Requests live in fixed-capacity *slots*
while decoding (serve/scheduler.py); everything per-sequence that the
step needs — temperature, top-k, top-p, the seed — rides in slot-indexed
host lanes so batch composition can change freely.

Sampling (:func:`sample_tokens`) takes one (B, V) logits block and
returns one (B,) token lane, with per-row temperature / top-k / top-p
masking as in ``repro/serve/session.py``. Greedy rows (temperature <= 0)
take the argmax.

**The random stream is the port's own.** torch cannot reproduce
``jax.random``, so sampled tokens differ from the JAX package's. The key
lane is the request's seed; :func:`fold_keys` hashes ``(seed, position)``
into one 64-bit key (splitmix64), and :func:`sample_tokens` seeds a
``torch.Generator`` on the logits' device with it (Philox on CUDA) and
takes the Gumbel-max of the masked logits. A token therefore depends only
on its request's seed, its position and its own logits — never on its
slot or its neighbours. The stream differs between CPU and CUDA
generators.

:class:`Session` is the tenant-facing wrapper: it namespaces request
ids, applies tenant-default sampling, and hands out
:class:`GenerationHandle` objects for streaming (callback or iterator)
and cancellation.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

_NEG = -1e30
_M64 = (1 << 64) - 1


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs. ``temperature <= 0`` means greedy
    (top_k / top_p are then ignored). ``top_k <= 0`` disables top-k;
    ``top_p >= 1`` disables nucleus filtering."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def key_data(self) -> np.uint64:
        """The key lane of this request's stream: its seed."""
        return np.uint64(self.seed & _M64)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer on uint64 (wrapping arithmetic)."""
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def fold_keys(keys, pos) -> np.ndarray:
    """Fold each row's position into its key lane: (B,) seeds, (B,)
    positions -> (B,) uint64 keys, so step t of a sequence draws from the
    same key no matter when or where it was admitted."""
    k = np.asarray(keys, np.uint64).reshape(-1)
    p = np.asarray(pos, np.int64).reshape(-1).astype(np.uint64)
    with np.errstate(over="ignore"):
        return _mix64(_mix64(k) + p * np.uint64(0x9E3779B97F4A7C15))


def _mask_top_k(scaled: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    v = scaled.shape[-1]
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = desc.gather(-1, torch.clamp(top_k - 1, 0, v - 1)[:, None].long())
    keep = (top_k <= 0)[:, None] | (scaled >= kth)
    return torch.where(keep, scaled, _NEG)


def _mask_top_p(scaled: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    probs = torch.softmax(scaled, dim=-1)
    order = torch.argsort(-probs, dim=-1, stable=True)
    sp = probs.gather(-1, order)
    # keep the smallest prefix whose mass reaches top_p (always >= 1 token)
    keep_sorted = (torch.cumsum(sp, dim=-1) - sp) < top_p[:, None]
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return torch.where(keep, scaled, _NEG)


def sample_tokens(logits: torch.Tensor, keys, temperature, top_k,
                  top_p) -> torch.Tensor:
    """Batched sampling with per-row parameters.

    logits (B, V) on any device; keys (B,) uint64 folded keys, temperature
    / top_p (B,) float and top_k (B,) int, all host lanes. Returns (B,)
    int64 tokens on the logits' device. Rows are independent: a row's
    sample depends on its own logits, parameters and key only. With no
    sampled row the step is one argmax."""
    temperature = np.asarray(temperature, np.float32).reshape(-1)
    greedy = torch.argmax(logits, dim=-1)
    rows = np.flatnonzero(temperature > 0.0)
    if not len(rows):
        return greedy
    dev = logits.device

    def lane(x, dt):
        return torch.from_numpy(np.asarray(x, dt).reshape(-1)).to(dev)

    t = lane(np.maximum(temperature, 1e-6), np.float32)[:, None]
    scaled = logits.float() / t
    scaled = _mask_top_k(scaled, lane(top_k, np.int64))
    scaled = _mask_top_p(scaled, lane(top_p, np.float32))
    keys = np.asarray(keys, np.uint64).reshape(-1)
    out = greedy.clone()
    for r in rows:
        gen = torch.Generator(device=dev).manual_seed(int(keys[r]))
        u = torch.rand(scaled.shape[-1], generator=gen, device=dev)
        out[r] = torch.argmax(scaled[r] - torch.log(-torch.log(u)))
    return out


# ---------------------------------------------------------------------------
# requests and handles
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Request:
    """One generation job. ``prompt`` is a 1-D int token array/list."""
    request_id: str
    prompt: np.ndarray
    max_new_tokens: int = 32
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    eos_id: Optional[int] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


class GenerationHandle:
    """Live view of one request: collected tokens, completion state,
    streaming, cancellation. Produced by ``PagedServeEngine.submit``.

    Lifecycle wall-clock timestamps (``time.perf_counter`` seconds) are
    stamped by the engine at its existing host boundaries — submit,
    admission, each token's host readback, finish — so per-request
    latencies (queue wait, TTFT, inter-token, end-to-end) are always
    reconstructable from the handle, with or without the obs layer:
    ``t_submit`` / ``t_admit`` / ``t_finish`` plus ``token_times[i]``
    (the emission time of ``tokens[i]``).
    """

    def __init__(self, request: Request, engine,
                 on_token: Optional[Callable[[Request, int], None]] = None):
        self.request = request
        self.tokens: list[int] = []
        self.finish_reason: Optional[str] = None
        self.t_submit: Optional[float] = None
        self.t_admit: Optional[float] = None
        self.t_finish: Optional[float] = None
        self.token_times: list[float] = []
        self._engine = engine
        self._on_token = on_token

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    # called by the engine ------------------------------------------------
    def _emit(self, token: int) -> None:
        self.tokens.append(token)
        self.token_times.append(time.perf_counter())
        if self._on_token is not None:
            self._on_token(self.request, token)

    def _finish(self, reason: str) -> None:
        if self.finish_reason is None:
            self.finish_reason = reason
            self.t_finish = time.perf_counter()

    # latency views --------------------------------------------------------
    @property
    def queue_wait(self) -> Optional[float]:
        """Seconds between submission and admission (None until admitted
        — e.g. a request cancelled while still queued)."""
        if self.t_admit is None or self.t_submit is None:
            return None
        return self.t_admit - self.t_submit

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token, measured from submission (includes queue
        wait and prefill)."""
        if not self.token_times or self.t_submit is None:
            return None
        return self.token_times[0] - self.t_submit

    def inter_token_latencies(self) -> list[float]:
        """Gaps between consecutive token emissions (empty for <2
        tokens). The engine emits at decode-step boundaries, so each gap
        is quantized to whole decode steps."""
        tt = self.token_times
        return [b - a for a, b in zip(tt, tt[1:])]

    @property
    def e2e(self) -> Optional[float]:
        """End-to-end seconds from submission to finish."""
        if self.t_finish is None or self.t_submit is None:
            return None
        return self.t_finish - self.t_submit

    def latency_summary(self) -> dict:
        """Per-request latency record (the ``--metrics`` table row)."""
        itl = self.inter_token_latencies()
        return {
            "request_id": self.request.request_id,
            "finish_reason": self.finish_reason,
            "n_tokens": len(self.tokens),
            "queue_wait": self.queue_wait,
            "ttft": self.ttft,
            "itl_mean": sum(itl) / len(itl) if itl else None,
            "e2e": self.e2e,
        }

    # called by the tenant -------------------------------------------------
    def cancel(self) -> None:
        """Stop this request at the next step boundary; its cache blocks
        return to the pool. Queued requests leave the queue immediately."""
        self._engine.cancel(self.request.request_id)

    def stream(self) -> Iterator[int]:
        """Yield this request's tokens as they are produced, pumping the
        engine while other tenants' requests make progress too."""
        seen = 0
        while True:
            while seen < len(self.tokens):
                yield self.tokens[seen]
                seen += 1
            if self.done:
                return
            self._engine.step()


class Session:
    """A tenant's view of a shared engine: namespaced request ids plus
    default sampling params. Multiple sessions submit into the same
    engine and their requests interleave in the continuous batch."""

    _ids = itertools.count()

    def __init__(self, engine, name: Optional[str] = None,
                 default_sampling: SamplingParams = SamplingParams()):
        self.engine = engine
        self.name = name or f"session{next(Session._ids)}"
        self.default_sampling = default_sampling
        self._req_ids = itertools.count()
        self.handles: dict[str, GenerationHandle] = {}

    def submit(self, prompt: Sequence[int], *, max_new_tokens: int = 32,
               sampling: Optional[SamplingParams] = None,
               eos_id: Optional[int] = None,
               on_token: Optional[Callable[[Request, int], None]] = None,
               ) -> GenerationHandle:
        rid = f"{self.name}/r{next(self._req_ids)}"
        req = Request(rid, np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens,
                      sampling=sampling or self.default_sampling,
                      eos_id=eos_id)
        handle = self.engine.submit(req, on_token=on_token)
        self.handles[rid] = handle
        return handle
