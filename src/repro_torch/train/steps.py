"""Train step: forward, backward, microbatch accumulation, global-norm
clipping and the optimizer update.

``make_train_step`` returns a ``(state, batch) -> (state, metrics)`` function
like the JAX package's. The model's backward is autograd through plain
PyTorch; the DCT projection, the column selection and the error feedback run
inside the optimizer update, never differentiated. The step is functional:
it returns a new ``TrainState`` and writes into no tensor of the old one.

Not yet ported: the telemetry collector, the in-step anomaly guard and fault
injection of ``repro.train.steps``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import transformer as T
from repro_torch.optim import apply_updates


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
    return {k: g * scale for k, g in tree.items()}, norm


def make_train_step(cfg, optimizer, *, grad_clip: float = 1.0):
    """(TrainState, batch) -> (TrainState, metrics). ``cfg.train_microbatch``
    rows per microbatch (0 = the whole batch at once), gradients summed in
    fp32 (the JAX package's bf16 accumulator option is not ported)."""

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        b = batch["tokens"].shape[0]
        mb = cfg.train_microbatch or b
        n_micro = max(1, b // mb)
        if n_micro == 1:
            grads, metrics = grad_fn(state.params, batch, cfg)
        else:
            grads, ms = None, []
            for i in range(n_micro):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                g, m = grad_fn(state.params, micro, cfg)
                part = {k: gi / n_micro for k, gi in g.items()}
                grads = part if grads is None else \
                    {k: grads[k] + part[k] for k in grads}
                ms.append(m)
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}

        if grad_clip:
            grads, gnorm = _clip_by_global_norm(grads, grad_clip)
        else:
            gnorm = _global_norm(grads)

        updates, new_opt = optimizer.update(grads, state.opt_state,
                                            state.params)
        new_params = apply_updates(state.params, updates)
        metrics = dict(metrics, grad_norm=gnorm)
        return TrainState(state.step + 1, new_params, new_opt), metrics

    return train_step


def init_state(cfg, optimizer, seed: int = 0, device=None) -> TrainState:
    params = T.init_params(cfg, seed, device)
    return TrainState(0, params, optimizer.init(params))
