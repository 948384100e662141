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

Data parallelism and placed state: under an active mesh
(``parallel.sharding.set_mesh``) the state holds this rank's blocks of the
parameters and of the optimizer state (``init_state``, by
``sharding.params_specs`` / ``opt_state_specs`` under the active policy),
and they stay blocks for the whole step (FSDP's schedule,
``parallel.fsdp``). The step takes the global batch and runs the model on
this rank's slice of it (``sharding.batch_specs_tree``: over the data
axes, over every axis under "pure_dp") under ``sharding.batch_cut`` of
those axes, so the MoE routes the global batch's tokens as the reference
does (``models.moe``) and the models' mesh bodies run over ``model``
(expert-parallel MoE, sequence-parallel attention). The forward is handed
the blocks and a ``parallel.fsdp.Held``'s ``use``: each use site (the embedding, each
layer, the head) gathers its split weights when it runs, cast to the
compute dtype, and gathers them again in the backward (the recomputation
under ``cfg.remat``, else saved-tensor hooks); an expert leaf comes as its
``model`` block, gathered over the data axes only, and so do the
attention heads' and the MLPs' matrices where Megatron's route applies
(``models.transformer.megatron_sites``): each rank computes its heads and
hidden units, one all-reduce over ``model`` after each row product. What
lives at once: one layer's weights (the one that runs), the embedding
while a tied unembedding or the MTP head still reads it, and in the
backward one site's regathered weights. Each split leaf's gradient leaves
the backward as this rank's block of its mean over the cut axes (a
reduce-scatter a site); the leaves that are not split are averaged with
the loss metrics (one all-reduce of a flat buffer per dtype). For a
model that routes tokens (an MoE block) with ``cfg.train_microbatch`` on
a cut batch, each rank takes its rows of each global microbatch
(``_cut_global_microbatches``: the reference's microbatches are rows of
the whole batch), so a microbatch's tokens are routed together; a dense
model keeps the contiguous cut, its microbatches rows of the rank's slice.
Microbatched, each microbatch's backward reduces its blocks and the step
adds them (FSDP's order: the gradients part from one process's by
rounding). Clipping reads the global norm from the blocks: each rank sums
the squares of its blocks, one all-reduce completes the leaves' sums
(``sharding.sum_squares``) and the leaves are added in order, so no
gradient is gathered for it; the norm parts from the one-process sum by
rounding and the clip factor by a few fp32 ulps. The optimizer is handed
the blocks as ``sharding.Block`` (their ``shape`` the whole one) beside
this rank's state blocks (``optim.transform``): the elementwise rules
update from the blocks, ZeRO-1's row-sharded rules take their rows from
the blocks (``parallel.zero``: a view, or an all-to-all of the overlaps),
a rule that needs a whole leaf gathers that leaf's gradient, runs and
cuts its update and drops the whole before the next. Each update is cut
to its parameter's block (``sharding.held_updates``) and added to it.
Gathering, reducing and cutting only move bits: where the gradients
average two shares and no product is split over ``model``, the gradients
the clip is handed are bit-equal to one process's in microbatches of one
rank's rows. Megatron's row products sum ``model`` partials, so a step on
a ``model`` axis holds one process's function within rounding. Under
"pure_dp" nothing is split: the step runs on the whole replicated
parameters and averages every gradient. Left for ROADMAP 6f: the
``seq_parallel`` residual stream, MLA's, Mamba's and RWKV's matrices and
the vocab-parallel head.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import transformer as T
from repro_torch.optim import apply_updates
from repro_torch.parallel import fsdp, sharding
from repro_torch.parallel.zero import gather_updates
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


def loss_fn(params: dict, batch: dict, cfg, use=None):
    inputs = {k: v for k, v in batch.items() if k != "targets"}
    logits, aux = T.forward(params, inputs, cfg, use=use)
    loss = _cross_entropy(logits, batch["targets"])
    metrics = {"ce": loss.detach()}
    loss = loss + aux["moe_aux"]
    if aux.get("mtp_logits") is not None:
        # the MTP head predicts target t+1 from position t (DeepSeek-V3):
        # full-length logits, the last position masked (rolled target)
        mtp_tgt = torch.roll(batch["targets"], -1, dims=1)
        logp = torch.log_softmax(aux["mtp_logits"].float(), dim=-1)
        nll = -torch.gather(logp, -1, mtp_tgt[..., None].long())[..., 0]
        s = nll.shape[1]
        w = (torch.arange(s, device=nll.device) < s - 1).float()[None, :]
        mtp = (nll * w).sum() / w.sum() / nll.shape[0]
        loss = loss + 0.3 * mtp
        metrics["mtp_ce"] = mtp.detach()
    metrics["loss"] = loss.detach()
    return loss, metrics


def grad_fn(params: dict, batch: dict, cfg):
    """Gradients of ``loss_fn`` w.r.t. every parameter (fp32, the
    parameters' dtype), and the metrics."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss, metrics = loss_fn(leaves, batch, cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, grads)), metrics


def _global_norm(leaves):
    """The l2 norm of a tree's leaves (a dict, or the leaves one at a
    time), summed leaf by leaf in order; a ``sharding.Block``'s sum is
    completed across the ranks' blocks (``sharding.sum_squares``)."""
    if isinstance(leaves, dict):
        leaves = leaves.values()
    return torch.sqrt(sharding.sum_squares(leaves))


def _clip(tree: dict, norm, max_norm: float) -> dict:
    """``tree`` scaled so its global norm ``norm`` is at most
    ``max_norm`` (each leaf, or each block of one, elementwise)."""
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    # g.float(): a bf16 gradient times the fp32 scale is fp32, as JAX
    # promotes it (a no-op for fp32 gradients)
    return {k: g.float() * scale for k, g in tree.items()}


def _clip_by_global_norm(tree: dict, max_norm: float):
    norm = _global_norm(tree)
    return _clip(tree, norm, max_norm), norm


_ACCUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _routes_tokens(cfg) -> bool:
    """Whether a block of ``cfg`` routes tokens across the batch (an MoE
    FFN: its capacity, positions and load-balance loss read every token of
    the batch it is given)."""
    return any(k in T.MOE_KINDS for k in cfg.block_kinds())


def _cut_global_microbatches(batch: dict, cfg, mesh, dp: tuple):
    """This rank's rows of each global microbatch, for a model that routes
    tokens: the reference takes microbatch i as rows ``[i R, (i+1) R)`` of
    the whole batch (R = B / n_micro, n_micro = B // train_microbatch) and
    cuts each over the data axes, so each microbatch's tokens are routed
    together. Returns (the rank's rows, microbatch i at ``[i R/n, (i+1)
    R/n)``; R/n; n_micro). Raises where a microbatch does not cut evenly:
    the reference then routes replicated tokens, which is not ported."""
    b = batch["tokens"].shape[0]
    n = mesh.size(dp)
    n_micro = max(1, b // cfg.train_microbatch)
    rows = b // n_micro
    if b % n_micro or rows % n:
        raise ValueError(
            f"train step: a batch of {b} rows in {n_micro} microbatches of "
            f"{rows} rows (train_microbatch {cfg.train_microbatch}) does "
            f"not cut into {n} equal blocks over {dp}; the MoE routes each "
            f"global microbatch's tokens together, which needs microbatches "
            f"of a multiple of {n} rows")
    idx, per = mesh.shard_index(dp), rows // n

    def take(v):
        if not isinstance(v, torch.Tensor) or not v.dim() or v.shape[0] != b:
            return v
        v = v.reshape(n_micro, rows, *v.shape[1:])
        return v[:, idx * per:(idx + 1) * per].reshape(
            n_micro * per, *v.shape[2:])

    return {k: take(v) for k, v in batch.items()}, per, n_micro


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
    placements = {}

    def param_placements(mesh):
        """The parameters' placements on ``mesh`` under the active policy
        and their whole shapes (meta tensors), derived once a pair."""
        key = (mesh, sharding.current_policy())
        if key not in placements:
            whole = T.init_params(cfg, 0, "meta")
            placements[key] = (sharding.params_specs(whole, mesh), whole)
        return placements[key]

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        chaos_step = None
        if chaos is not None:
            batch, chaos_step = strip_chaos_key(batch)
        mesh = sharding.active_mesh()
        params, p_specs, dp, split = state.params, None, (), set()
        mb = n_micro = None
        if mesh is not None:
            p_specs, whole = param_placements(mesh)
            sharding.check_blocks(params, whole, p_specs, mesh,
                                  what="parameter")
            split = {k for k, s in p_specs.items() if s.splits(mesh)}
            # the axes this rank's slice of the batch is cut over (the data
            # axes; every axis under "pure_dp"): the gradients average
            # over them
            b_specs = sharding.batch_specs_tree(batch)
            dp = tuple(a for _, axes, _ in b_specs["tokens"].splits(mesh)
                       for a in axes)
            if dp and _routes_tokens(cfg) and cfg.train_microbatch:
                batch, mb, n_micro = _cut_global_microbatches(
                    batch, cfg, mesh, dp)
            else:
                batch = sharding.shard_tree(batch, b_specs)

        def grads_of(part):
            """The gradients of one (micro)batch: the split leaves' as this
            rank's blocks of the mean over ``dp`` (``parallel.fsdp``), the
            others whole, this rank's share."""
            with sharding.batch_cut(dp):
                if not split:
                    return grad_fn(params, part, cfg)
                g, m, _ = fsdp.grad_fn(params, p_specs, whole, mesh, dp, adt,
                                       loss_fn, part, cfg)
                return g, m

        b = batch["tokens"].shape[0]
        if mb is None:
            mb = cfg.train_microbatch or b
            n_micro = max(1, b // mb)
        if n_micro == 1:
            grads, metrics = grads_of(batch)
            grads = {k: g.to(adt) for k, g in grads.items()}
        else:
            grads, ms = None, []
            for i in range(n_micro):
                g, m = grads_of({k: v[i * mb:(i + 1) * mb]
                                 for k, v in batch.items()})
                part = {k: (gi / n_micro).to(adt) for k, gi in g.items()}
                grads = part if grads is None else \
                    {k: grads[k] + part[k] for k in grads}
                ms.append(m)
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}

        if dp:
            names = [k for k in grads if k not in split]
            mnames = list(metrics)
            avg = sharding.all_reduce_mean(
                [grads[k] for k in names] + [metrics[k] for k in mnames], dp)
            grads.update(zip(names, avg[:len(names)]))
            metrics = dict(zip(mnames, avg[len(names):]))

        if chaos_step is not None:
            grads = chaos.tamper_grads(chaos_step, grads)

        if split:
            # the optimizer takes this rank's blocks (``sharding.Block``:
            # the whole shape, the placement); a rule that needs a whole
            # leaf gathers it for that leaf alone
            grads = {k: sharding.Block(g, p_specs[k], mesh) if k in split
                     else g for k, g in grads.items()}
            params = {k: sharding.Block(p, p_specs[k], mesh) if k in split
                      else p for k, p in params.items()}
        # the global norm: each block's sum of squares completed by one
        # all-reduce of the blocks' partial sums (no gradient gathered),
        # the leaves added in order; it parts from the one-process sum by
        # rounding, the clip scale by a few ulps
        gnorm = _global_norm(grads)
        if grad_clip:
            grads = _clip(grads, gnorm, grad_clip)

        metrics = dict(metrics)
        if telemetry:
            with collect() as col:
                updates, new_opt = optimizer.update(grads, state.opt_state,
                                                    params)
            tel = col.tree()
            if tel:
                metrics["telemetry"] = tel
        else:
            updates, new_opt = optimizer.update(grads, state.opt_state,
                                                params)
        del params, grads
        if p_specs is None:
            updates = gather_updates(updates)
        else:
            updates = sharding.held_updates(updates, p_specs, mesh)
        new_params = apply_updates(state.params, updates)
        metrics["grad_norm"] = gnorm
        new_state = TrainState(state.step + 1, new_params, new_opt)
        if guard:
            # gnorm is a sum of squares over every gradient element, so a
            # NaN/Inf anywhere in the gradients poisons it; the updates
            # cover the optimizer's own arithmetic (each rank's blocks of
            # them, the ranks' flags combined)
            ok = all_finite_tree(updates)
            if mesh is not None:
                bad = (~ok).to(torch.float32).reshape(1)
                ok = mesh.all_reduce_sum_(bad, mesh.axis_names)[0] == 0
            flag = torch.isfinite(metrics["loss"]) & torch.isfinite(gnorm) \
                & ok
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
    optimizer's state of them. Under an active mesh the state holds this
    rank's blocks: the optimizer's ``init`` cuts its own, and the
    parameters are cut by ``sharding.params_specs`` under the active
    policy (``sharding.shard_tree``)."""
    params = T.init_params(cfg, seed, device)
    opt_state = optimizer.init(params)
    mesh = sharding.active_mesh()
    if mesh is not None:
        params = sharding.shard_tree(
            params, sharding.params_specs(params, mesh), mesh)
    return TrainState(0, params, opt_state)
