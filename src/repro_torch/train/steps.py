"""Train and eval steps: forward, backward, microbatch accumulation,
global-norm clipping and the optimizer update.

``make_train_step`` returns a ``(state, batch) -> (state, metrics)`` function
like the JAX package's. The model's backward is autograd through plain
PyTorch; the DCT projection, the column selection and the error feedback run
inside the optimizer update, never differentiated. The step is functional:
it returns a new ``TrainState`` and writes into no tensor of the old one.
That is what lets the guarded step (``guard=True``) refuse an update by
returning the old state whole (``train.resilience``). ``telemetry=True``
installs a stats collector around the optimizer update and returns the
rules' per-leaf :class:`~repro_torch.telemetry.stats.SubspaceStats` under
``metrics["telemetry"]``, on the device (the Trainer copies them to the
host in one piece).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import transformer as T
from repro_torch.optim import apply_updates
from repro_torch.telemetry.stats import collect
from repro_torch.train.chaos import strip_chaos_key
from repro_torch.train.resilience import all_finite_tree, select_tree


class TrainState(NamedTuple):
    step: int
    params: dict
    opt_state: Any


def _cross_entropy(logits, targets):
    """Mean next-token NLL; fp32 log-softmax. targets: (B, S) int."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return nll.mean()


def loss_fn(params: dict, batch: dict, cfg):
    inputs = {k: v for k, v in batch.items() if k != "targets"}
    logits, aux = T.forward(params, inputs, cfg)
    loss = _cross_entropy(logits, batch["targets"])
    metrics = {"ce": loss.detach()}
    loss = loss + aux["moe_aux"]
    metrics["loss"] = loss.detach()
    return loss, metrics


def grad_fn(params: dict, batch: dict, cfg):
    """Gradients of ``loss_fn`` w.r.t. every parameter (fp32, the
    parameters' dtype), and the metrics."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss, metrics = loss_fn(leaves, batch, cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, grads)), metrics


def _global_norm(tree: dict):
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


def _clip_by_global_norm(tree: dict, max_norm: float):
    norm = _global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    # g.float(): a bf16 gradient times the fp32 scale is fp32, as JAX
    # promotes it (a no-op for fp32 gradients)
    return {k: g.float() * scale for k, g in tree.items()}, norm


_ACCUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_train_step(cfg, optimizer, *, grad_clip: float = 1.0,
                    accum_dtype: str = "float32", telemetry: bool = False,
                    guard: bool = False, chaos=None):
    """(TrainState, batch) -> (TrainState, metrics). ``cfg.train_microbatch``
    rows per microbatch (0 = the whole batch at once).

    ``accum_dtype``: the gradients' dtype, and that of the microbatch
    accumulator: "float32" (default) or "bfloat16", which rounds each
    microbatch's share to bf16 and sums in bf16, as the JAX package does.

    ``guard=True`` arms the anomaly guard: one ``all_finite`` flag over the
    loss, the gradient norm and the updates, returned as
    ``metrics["all_finite"]``. The flag is read on the host at the end of
    the step (one sync): when it is false the old state is returned whole,
    step counter included (``resilience.select_tree``). With ``guard=False``
    the step launches what it launched before the option existed.

    ``telemetry=True`` installs a stats collector around the optimizer
    update; the per-leaf :class:`SubspaceStats` the rules record come back
    under ``metrics["telemetry"]``. The stats only read what the update
    computes: the new state is bit-equal to the one without telemetry.
    Off, the step launches what it launched before the option existed.

    ``chaos``: a :class:`~repro_torch.train.chaos.ChaosPlan` whose ``grads``
    faults are added to the gradients on the data step the plan's batch
    wrapper stamps into each batch (tests and drills only)."""
    if accum_dtype not in _ACCUM_DTYPES:
        raise ValueError(f"accum_dtype {accum_dtype!r}: expected one of "
                         f"{sorted(_ACCUM_DTYPES)}")
    adt = _ACCUM_DTYPES[accum_dtype]

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        chaos_step = None
        if chaos is not None:
            batch, chaos_step = strip_chaos_key(batch)
        b = batch["tokens"].shape[0]
        mb = cfg.train_microbatch or b
        n_micro = max(1, b // mb)
        if n_micro == 1:
            grads, metrics = grad_fn(state.params, batch, cfg)
            grads = {k: g.to(adt) for k, g in grads.items()}
        else:
            grads, ms = None, []
            for i in range(n_micro):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                g, m = grad_fn(state.params, micro, cfg)
                part = {k: (gi / n_micro).to(adt) for k, gi in g.items()}
                grads = part if grads is None else \
                    {k: grads[k] + part[k] for k in grads}
                ms.append(m)
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}

        if chaos_step is not None:
            grads = chaos.tamper_grads(chaos_step, grads)

        if grad_clip:
            grads, gnorm = _clip_by_global_norm(grads, grad_clip)
        else:
            gnorm = _global_norm(grads)

        metrics = dict(metrics)
        if telemetry:
            with collect() as col:
                updates, new_opt = optimizer.update(grads, state.opt_state,
                                                    state.params)
            tel = col.tree()
            if tel:
                metrics["telemetry"] = tel
        else:
            updates, new_opt = optimizer.update(grads, state.opt_state,
                                                state.params)
        new_params = apply_updates(state.params, updates)
        metrics["grad_norm"] = gnorm
        new_state = TrainState(state.step + 1, new_params, new_opt)
        if guard:
            # gnorm is a sum of squares over every gradient element, so a
            # NaN/Inf anywhere in the gradients poisons it; the updates
            # cover the optimizer's own arithmetic
            flag = (torch.isfinite(metrics["loss"]) & torch.isfinite(gnorm)
                    & all_finite_tree(updates))
            new_state = select_tree(flag, new_state, state)
            metrics["all_finite"] = flag
        return new_state, metrics

    return train_step


def make_eval_step(cfg):
    """(params, batch) -> metrics of ``loss_fn``, without gradients."""

    @torch.no_grad()
    def eval_step(params: dict, batch: dict) -> dict:
        _, metrics = loss_fn(params, batch, cfg)
        return metrics

    return eval_step


def init_state(cfg, optimizer, seed: int = 0, device=None) -> TrainState:
    """Step 0: ``init_params(cfg, seed, device)`` (None: the card) and the
    optimizer's state of them."""
    params = T.init_params(cfg, seed, device)
    return TrainState(0, params, optimizer.init(params))
