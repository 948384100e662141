"""Serving engines: fixed-batch dense and continuous-batching paged.

The port of ``repro/serve/engine.py``. Where the JAX engines jit their step
closures, these run the same steps as plain methods under
``torch.inference_mode()``.

``make_serve_step`` is one new token for every sequence in the batch
against a dense cache.

``ServeEngine`` is the fixed-batch dense engine: one prefill, then decode
steps. Sampling and eos detection run on the step's logits; the host reads
back one small token lane per step, needed anyway to stream tokens and stop
early. Positions are a per-sequence ``(B,)`` lane end to end.

``PagedServeEngine`` is the production path for the paged families: a
block-pool KV cache (serve/kv_cache.py), chunked prefill into the pools, a
continuous-batching scheduler (serve/scheduler.py) admitting and retiring
requests between decode steps, per-sequence sampling lanes
(serve/session.py), and the ``flash_decode`` CUDA kernel reading K/V
through the block table. A sequence's output depends only on its own
prompt, seed and budget, never on its neighbours -- in an MoE block as long
as no expert overflows its capacity: each decode step routes every slot
lane together (inactive ones too, as the JAX engine does), each prefill
chunk its padded tokens, and an overflow drops tokens by their order in
that batch. ``ServeEngine`` serves every family (an encoder-decoder's or a
VLM's prompts with their stub frames or image embeddings),
``PagedServeEngine`` the blocks of ``transformer.PAGED_KINDS`` (not MLA,
not the recurrent Mamba and RWKV blocks, not the encoder-decoder and
cross-attention blocks).

Both engines cast the weights to the compute dtype once, when built, and
run on the device the parameters lie on.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.models import transformer as T

from .kv_cache import PagedCacheConfig, PagedKVCache
from .scheduler import Scheduler
from .session import GenerationHandle, Request, fold_keys, sample_tokens


def _serve_metrics():
    """Register (or fetch) the serving instruments on the process-wide
    registry (the JAX engine's catalog). The per-step hot path is
    tuple-keyed dict updates, no-ops while obs is disabled."""
    r = obs.registry()
    return {
        "ttft": r.histogram(
            "serve_ttft_seconds",
            "submit -> first token (includes queue wait and prefill)"),
        "itl": r.histogram(
            "serve_itl_seconds",
            "inter-token latency (gap between consecutive emissions)"),
        "queue_wait": r.histogram(
            "serve_queue_wait_seconds", "submit -> admission"),
        "e2e": r.histogram(
            "serve_e2e_seconds", "submit -> finish (any reason)"),
        "tokens": r.counter("serve_tokens_total", "tokens emitted"),
        "submitted": r.counter("serve_requests_submitted_total",
                               "requests accepted by submit()"),
        "finished": r.counter("serve_requests_finished_total",
                              "requests retired, by finish reason",
                              labels=("reason",)),
        "admissions": r.counter("serve_admissions_total",
                                "requests admitted into a slot"),
        "backpressure": r.counter(
            "serve_backpressure_steps_total",
            "steps the queue head stayed blocked, by cause",
            labels=("cause",)),
        "cancels": r.counter("serve_cancellations_total",
                             "cancellations processed, by request state",
                             labels=("state",)),
        "slots_active": r.gauge("serve_slots_active",
                                "occupied decode slot lanes"),
        "queue_depth": r.gauge("serve_queue_depth", "pending requests"),
        "pool_util": r.gauge(
            "serve_pool_utilization",
            "tokens held / token capacity of the held blocks"),
        "pool_frag": r.gauge(
            "serve_pool_fragmentation",
            "internal fragmentation of held blocks (1 - utilization)"),
        "pool_used": r.gauge("serve_pool_used_blocks", "blocks in use"),
        "pool_free": r.gauge("serve_pool_free_blocks", "blocks free"),
    }


def _device_of(params: dict) -> torch.device:
    return next(iter(params.values())).device


def make_serve_step(cfg):
    """(params, cache, token (B,), pos () or (B,)) -> (logits (B,V), cache)."""

    def serve_step(params, cache, token, pos):
        return T.decode_step(params, cache, token, pos, cfg)

    return serve_step


# ---------------------------------------------------------------------------
# dense fixed-batch engine
# ---------------------------------------------------------------------------
class ServeEngine:
    """Fixed-batch dense decoding. ``temperature > 0`` samples every row
    from one ``torch.Generator`` seeded with ``seed`` (the port's own
    stream, like the JAX engine's shared key but not its numbers)."""

    def __init__(self, cfg, params, *, max_len: int = 2048,
                 temperature: float = 0.0, seed: int = 0):
        self.cfg = cfg
        self.params = T.cast_params(params, cfg)
        self.max_len = max_len
        self.temperature = temperature
        self._step = make_serve_step(cfg)
        self._gen = torch.Generator(device=_device_of(params)).manual_seed(
            seed)

    def _sample(self, logits):
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        u = torch.rand(logits.shape, generator=self._gen,
                       device=logits.device)
        return torch.argmax(logits.float() / self.temperature
                            - torch.log(-torch.log(u)), dim=-1)

    @torch.inference_mode()
    def generate(self, batch: dict, *, max_new_tokens: int = 32,
                 eos_id: int | None = None) -> torch.Tensor:
        """batch: ``{'tokens': (B, S) prompt}``, with the modality stubs
        ``'frames'`` / ``'image_embeds'`` where the config has them (passed
        to ``prefill``, whose cache then holds their cross-attention keys
        and values). Returns (B, <= max_new_tokens) int64 generations. Rows that hit ``eos_id`` keep
        emitting it; the loop stops early once every row has."""
        prompt = batch["tokens"]
        b, s = prompt.shape
        logits, cache, _ = T.prefill(self.params, batch, self.cfg,
                                     max_len=self.max_len)
        token = self._sample(logits)
        done = token == eos_id if eos_id is not None else None
        out = [token]
        pos = torch.full((b,), s, dtype=torch.long, device=prompt.device)
        for _ in range(max_new_tokens - 1):
            if done is not None and bool(done.all()):
                break
            logits, cache = self._step(self.params, cache, token, pos)
            token = self._sample(logits)
            if done is not None:
                done = done | (token == eos_id)
                token = torch.where(done, eos_id, token)
            out.append(token)
            pos = pos + 1
        return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# paged continuous-batching engine
# ---------------------------------------------------------------------------
class PagedServeEngine:
    """Continuous-batching serving over a paged KV cache.

    Submit :class:`~repro_torch.serve.session.Request` objects (usually via
    a :class:`~repro_torch.serve.session.Session`); call :meth:`step` to
    advance every running sequence by one token (admitting queued requests
    and retiring finished ones at the boundary), or :meth:`run` to drain.
    ``num_slots`` fixes the decode batch width; ``block_size`` /
    ``num_blocks`` size the cache pool; admission reserves a request's
    worst-case blocks up front, so backpressure is a queue, never a
    mid-stream failure. The pools and the prefill scratch live on the
    parameters' device and are written in place.
    """

    def __init__(self, cfg, params, *, block_size: int = 16,
                 num_blocks: int = 256, max_blocks_per_seq: int | None = None,
                 num_slots: int = 4, max_prefill_len: int | None = None,
                 prefill_chunk: int = 16, num_splits: int = 1):
        self.cfg = cfg
        self.params = T.cast_params(params, cfg)
        dev = _device_of(params)
        mbs = max_blocks_per_seq if max_blocks_per_seq is not None \
            else num_blocks
        self.cache_cfg = PagedCacheConfig(
            block_size=block_size, num_blocks=num_blocks,
            max_blocks_per_seq=mbs)
        # raises for families the paged path does not serve
        self.cache = PagedKVCache(cfg, self.cache_cfg, num_slots, dev)
        self.sched = Scheduler(num_slots, self.cache.allocator,
                               max_blocks_per_seq=mbs)
        self.prefill_chunk = prefill_chunk
        self.num_splits = num_splits
        mpl = max_prefill_len if max_prefill_len is not None \
            else self.cache_cfg.max_seq_len
        # the scratch length must tile both the fixed-width prefill chunk
        # and the pool blocks (the final copy reshapes into blocks)
        tile = math.lcm(prefill_chunk, block_size)
        self.max_prefill_len = -(-mpl // tile) * tile
        self.scratch = T.init_prefill_scratch(cfg, self.max_prefill_len, dev)

        self.handles: dict[str, GenerationHandle] = {}
        self._cancelled: set[str] = set()
        self.steps = 0
        self.tokens_emitted = 0
        self.last_logits: torch.Tensor | None = None
        # per-step runtime stats (slot occupancy, pool utilization /
        # fragmentation from the BlockAllocator, queue depth) — refreshed
        # at every step boundary whether or not the obs layer is enabled
        self.step_stats: dict = {}
        self._m = _serve_metrics()
        self._tracer = obs.tracer()

    # -- submission API ----------------------------------------------------
    def submit(self, req: Request,
               on_token: Optional[Callable] = None) -> GenerationHandle:
        if req.request_id in self.handles:
            raise ValueError(f"duplicate request id {req.request_id!r}")
        if len(req.prompt) > self.max_prefill_len:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens exceeds "
                f"max_prefill_len={self.max_prefill_len}")
        self.sched.enqueue(req)           # validates the block budget
        handle = GenerationHandle(req, self, on_token=on_token)
        handle.t_submit = time.perf_counter()
        self.handles[req.request_id] = handle
        self._m["submitted"].inc()
        return handle

    def cancel(self, request_id: str) -> None:
        """Mark a request for cancellation; it is dropped (queued) or
        retired with its blocks freed (running) at the next step
        boundary."""
        if request_id in self.handles and \
                not self.handles[request_id].done:
            self._cancelled.add(request_id)

    # -- internals ---------------------------------------------------------
    def _retire(self, slot: int, reason: str) -> None:
        req = self.sched.retire(slot)
        self.cache.clear_slot(slot)
        handle = self.handles[req.request_id]
        handle._finish(reason)
        self._m["finished"].inc(1, (reason,))
        if handle.e2e is not None:
            self._m["e2e"].observe(handle.e2e)

    def _process_cancellations(self) -> None:
        for rid in list(self._cancelled):
            self._cancelled.discard(rid)
            if self.sched.drop_pending(rid):
                self.handles[rid]._finish("cancelled")
                self._m["cancels"].inc(1, ("queued",))
                self._m["finished"].inc(1, ("cancelled",))
                continue
            slot = self.sched.slot_of(rid)
            if slot is not None:
                self._m["cancels"].inc(1, ("running",))
                self._retire(slot, "cancelled")

    @torch.inference_mode()
    def _prefill(self, req: Request, slot: int) -> int:
        """Chunked prefill into the dense scratch, whole-block copy into
        the pools, then the request's first token (sampled with the key
        folded at the last prompt position, as every decode step folds at
        its input position). Returns the token."""
        s = len(req.prompt)
        c = self.prefill_chunk
        dev = self.cache.device
        padded = np.zeros((1, -(-s // c) * c), np.int64)
        padded[0, :s] = req.prompt
        toks = torch.from_numpy(padded).to(dev)
        for start in range(0, s, c):
            take = max(min(s - 1 - start, c - 1), 0)
            logits, _ = T.prefill_chunk(self.params, self.scratch,
                                        toks[:, start:start + c], start,
                                        take, self.cfg)
        T.write_prefill_to_pools(self.cache.pools, self.scratch,
                                 self.sched.allocator.table(req.request_id),
                                 s, self.cache_cfg.block_size)
        self.cache.bind_slot(slot, req.request_id)
        lanes = self.sched.lanes
        tok = sample_tokens(logits, fold_keys(lanes.key[slot:slot + 1],
                                              [s - 1]),
                            lanes.temperature[slot:slot + 1],
                            lanes.top_k[slot:slot + 1],
                            lanes.top_p[slot:slot + 1])
        return int(tok[0])

    def _admit(self, slot: int, req: Request) -> None:
        handle = self.handles[req.request_id]
        handle.t_admit = time.perf_counter()
        self._m["admissions"].inc()
        if handle.queue_wait is not None:
            self._m["queue_wait"].observe(handle.queue_wait)
        s = len(req.prompt)
        with self._tracer.span("serve/admit", step=self.steps,
                               prompt_len=s, slot=slot):
            tok = self._prefill(req, slot)
        handle._emit(tok)
        self.tokens_emitted += 1
        self._m["tokens"].inc()
        if handle.ttft is not None:
            self._m["ttft"].observe(handle.ttft)
        n = self.sched.note_token(slot)
        lanes = self.sched.lanes
        if lanes.eos[slot] >= 0 and tok == lanes.eos[slot]:
            self._retire(slot, "eos")
        elif n >= req.max_new_tokens:
            self._retire(slot, "length")
        else:
            lanes.token[slot] = tok
            lanes.pos[slot] = s

    @torch.inference_mode()
    def _decode(self) -> np.ndarray:
        """One paged decode step of every slot lane and its sampling; the
        step's one host sync is the read of the token lane."""
        lanes = self.sched.lanes
        logits, _ = T.decode_step_paged(
            self.params, self.cache.pools, lanes.token, lanes.pos,
            self.cache.block_table(), lanes.active, self.cfg,
            num_splits=self.num_splits)
        tok = sample_tokens(logits, fold_keys(lanes.key, lanes.pos),
                            lanes.temperature, lanes.top_k, lanes.top_p)
        self.last_logits = logits   # tests / debugging only
        return tok.cpu().numpy()

    def step(self) -> bool:
        """Advance every running sequence by one token. Admissions and
        retirements happen at this boundary. Returns True while work
        remains."""
        self._process_cancellations()
        for slot, req in self.sched.admit_ready():
            self._admit(slot, req)
        cause = self.sched.blocked_reason()
        if cause is not None:
            self._m["backpressure"].inc(1, (cause,))
        if not self.sched.running:
            self._refresh_step_stats()
            return self.sched.has_work

        lanes = self.sched.lanes
        with self._tracer.span("serve/decode_step", step=self.steps,
                               batch=len(self.sched.running)):
            tok_h = self._decode()
            self.steps += 1
        for slot in sorted(self.sched.running):
            req = self.sched.running[slot]
            t = int(tok_h[slot])
            handle = self.handles[req.request_id]
            handle._emit(t)
            self.tokens_emitted += 1
            self._m["tokens"].inc()
            tt = handle.token_times
            if len(tt) >= 2:
                self._m["itl"].observe(tt[-1] - tt[-2])
            n = self.sched.note_token(slot)
            lanes.token[slot] = t
            lanes.pos[slot] += 1
            if lanes.eos[slot] >= 0 and t == lanes.eos[slot]:
                self._retire(slot, "eos")
            elif n >= req.max_new_tokens:
                self._retire(slot, "length")
        self._refresh_step_stats()
        return self.sched.has_work

    def _refresh_step_stats(self) -> None:
        """Rebuild :attr:`step_stats` (and, when obs is on, the gauges)
        from host-side scheduler/allocator state. Always runs at the step
        boundary — the dict is the no-obs-needed view of slot occupancy
        and block-pool health (utilization, internal fragmentation)."""
        alloc = self.cache.allocator.stats()
        running = len(self.sched.running)
        pending = len(self.sched.pending)
        self.step_stats = {
            "step": self.steps,
            "running": running,
            "pending": pending,
            "tokens_emitted": self.tokens_emitted,
            "used_blocks": alloc["used_blocks"],
            "free_blocks": alloc["free_blocks"],
            "utilization": alloc["utilization"],
            "fragmentation": alloc["fragmentation"],
        }
        self._m["slots_active"].set(running)
        self._m["queue_depth"].set(pending)
        self._m["pool_util"].set(alloc["utilization"])
        self._m["pool_frag"].set(alloc["fragmentation"])
        self._m["pool_used"].set(alloc["used_blocks"])
        self._m["pool_free"].set(alloc["free_blocks"])

    def run(self) -> None:
        """Drain the queue: step until every request has finished."""
        while self.step():
            pass

    def stats(self) -> dict:
        s = self.cache.stats()
        s["pending"] = len(self.sched.pending)
        s["running"] = len(self.sched.running)
        s["steps"] = self.steps
        s["tokens_emitted"] = self.tokens_emitted
        return s
