"""The ranks of the ZeRO-1 tests (``test_torch_zero.py``): cases, inputs and
the work each spawned rank does. No JAX here, so a rank imports torch and
the port only.

Each world is spawned processes on ``gloo`` with CPU tensors, the process
group started from a file in the test's directory (no port: the suite's
workers cannot collide), one intra-op thread a rank. Rank 0 writes what
the world computed to ``<dir>/results.pt`` (tensors only, loadable with
``weights_only``); every rank writes its traceback to ``<dir>/rank<r>.err``
if it fails.
"""
import contextlib
import os
import time
import traceback
import zlib

import numpy as np
import torch

# the reference's leaves (tests/test_zero_parity.py): stacked, odd rows
# first, transposed orientation, a 1-D full-rank leaf, and one whose 38
# rows split in two but not in four
SHAPES = {"w": (3, 64, 48), "odd": (80, 33), "wide": (33, 80),
          "bad": (38, 20), "norm": (64,)}
STEPS = 6
CASES = {
    "dct_adamw-off": ("dct_adamw", dict(rank=8, fused="off")),
    "dct_adamw-on": ("dct_adamw", dict(rank=8, fused="on")),
    "dct_adamw-fft": ("dct_adamw", dict(rank=8, fused="fft")),
    "dct_adamw-fp32ef": ("dct_adamw", dict(rank=8, fused="off",
                                           ef_dtype="fp32")),
    "dct_adamw-noef": ("dct_adamw", dict(rank=8, fused="off",
                                         error_feedback=False)),
    "dct_adamw-interval2": ("dct_adamw", dict(rank=8, fused="off",
                                              update_interval=2)),
    "muon-full": ("muon", dict(fused="on")),
    "muon-rank16": ("muon", dict(rank=16, fused="on")),
    "trion": ("trion", dict(rank=16, fused="on")),
    "dion": ("dion", dict(rank=16, fused="on")),
    # not zero_shardable: its state is held by rows, its update whole
    "fira": ("fira", dict(rank=8, projector="dct", fused="on")),
}
TELEMETRY = {"dct_adamw-interval2": CASES["dct_adamw-interval2"],
             "trion": CASES["trion"]}
TELEMETRY_STEPS = 3
CKPT_CASE = "dct_adamw-on"
CKPT_STEP = 2
TRAIN = dict(arch="llama-350m", batch=4, seq=32, steps=2)


def planted(shape, seed, r):
    """G (oriented, n last) whose S = G @ Q has r planted columns 8x larger
    than the rest (``test_torch_fused_step.planted`` with the port's DCT
    basis): the top-r cut has a clear margin."""
    from repro_torch.core.dct import dct_basis_np

    rng = np.random.default_rng(seed)
    *batch, m, n = shape
    s = rng.standard_normal(shape)
    scale = np.full((*batch, n), 0.125)
    for b in np.ndindex(*batch):
        scale[b][rng.permutation(n)[:r]] = 1.0
    q = np.asarray(dct_basis_np(n), np.float64)
    return ((s * scale[..., None, :]) @ q.T).astype(np.float32)


def grads_np(step: int, r: int) -> dict:
    """Step ``step``'s gradients: planted in the oriented layout, handed
    over in the parameter's."""
    out = {}
    for i, (k, shape) in enumerate(SHAPES.items()):
        seed = 1000 * step + i
        if len(shape) < 2:
            out[k] = np.random.default_rng(seed).standard_normal(
                shape).astype(np.float32)
            continue
        m, n = shape[-2:]
        if n <= m:
            out[k] = planted(shape, seed, r)
        else:
            out[k] = np.swapaxes(planted((*shape[:-2], n, m), seed, r),
                                 -1, -2).copy()
    return out


def case_rank(kw: dict) -> int:
    return kw.get("rank") or 16


def params_t() -> dict:
    return {k: torch.zeros(s) for k, s in SHAPES.items()}


def flat_tensors(tree) -> dict:
    """``{checkpoint key: tensor}`` of a state tree (ints as 0-d int64)."""
    from repro_torch.train.checkpoint import tree_items

    return {"||".join(p): (v if isinstance(v, torch.Tensor)
                           else torch.tensor(v))
            for p, v in tree_items(tree)}


def run_case(name: str, kw: dict, steps: int = STEPS, zero=None):
    """``steps`` updates of preset ``name`` (with ``zero``, on the active
    mesh) on ``grads_np``: the (whole) updates of each step, the last state
    (whole) and, on a mesh, the state's ``(held, whole)`` bytes."""
    from repro_torch.optim.api import get_optimizer
    from repro_torch.parallel import sharding
    from repro_torch.parallel.zero import gather_updates

    opt = get_optimizer(name, lr=0.01, zero=zero, **kw)
    params = params_t()
    state = opt.init(params)
    ups = []
    for t in range(steps):
        g = {k: torch.from_numpy(v) for k, v in
             grads_np(t, case_rank(kw)).items()}
        u, state = opt.update(g, state, params)
        ups.append(gather_updates(u))
    mesh = sharding.active_mesh()
    if mesh is not None:
        specs = sharding.optimizer_state_specs(opt, params, zero=zero,
                                               mesh=mesh)
        held = sharding.state_bytes(state, specs, mesh)
        state = sharding.gather_tree(state, specs, mesh)
    else:
        held = None
    return ups, state, held


def train_run(zero):
    """``TRAIN["steps"]`` train steps of the smoke llama with DCT-AdamW
    (rank 128 = n: every column is selected) on the whole batch: losses,
    parameters and the (whole) optimizer state."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.optim.api import get_optimizer
    from repro_torch.parallel import sharding
    from repro_torch.train.steps import init_state, make_train_step

    cfg = get_config(TRAIN["arch"], smoke=True)
    opt = get_optimizer("dct_adamw", lr=0.01, zero=zero)
    step = make_train_step(cfg, opt)
    batch_fn = make_batch_fn(cfg, TRAIN["seq"], TRAIN["batch"], seed=0,
                             device="cpu")
    state = init_state(cfg, opt, 0, "cpu")
    losses = []
    for t in range(TRAIN["steps"]):
        state, metrics = step(state, batch_fn(t))
        losses.append(float(metrics["loss"]))
    mesh = sharding.active_mesh()
    if mesh is not None:
        with sharding.set_mesh(None):
            abstract = init_state(cfg, opt, 0, "meta")
        state = sharding.gather_tree(state, sharding.train_state_specs(
            abstract, zero=zero, mesh=mesh), mesh)
    return losses, state.params, state.opt_state


# the (data, model) meshes each world adds for the placed train state
# (``parallel/sharding.py``): the smoke llama's train step under each
# layout, with DCT-AdamW (q8 EF) and Trion, ZeRO off and on
MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2),)}
MESH_OPTS = {"dct_adamw": ("dct_adamw", dict(rank=16)),
             "trion": ("trion", dict(rank=16))}
MESH_STEPS = 2
# pure_dp beside fsdp_tp, for DCT-AdamW with ZeRO off and on
PURE_DP = (("dct_adamw", "off"), ("dct_adamw", "1"))
# saved after MESH_STEPS steps at (2, 2), restored at (1, 2) and at one
# process for one more step
MESH_CKPT = ("dct_adamw", "1")
DECODE_ARCHS = ("llama-350m", "deepseek-moe-16b")
MOE_ARCHS = ("deepseek-moe-16b",)


def mesh_key(shape) -> str:
    return "x".join(map(str, shape))


def batch_rows(shape, layout: str) -> int:
    """The rows of the global batch one rank runs on ``shape`` (data,
    model) under ``layout``: the one-process witness's microbatch."""
    n = shape[0] * (shape[1] if layout == "pure_dp" else 1)
    return TRAIN["batch"] // n


@contextlib.contextmanager
def clip_spy(records: list):
    """Record each train step's clip (``train.steps._clip``): the
    gradients it is handed, whole (a block gathered), the norm the step
    computed (from the blocks' sums of squares on a mesh) and the norm of
    the whole gradients as one process sums them."""
    from repro_torch.parallel import sharding
    from repro_torch.train import steps

    orig = steps._clip

    def spy(tree, norm, max_norm):
        whole = {k: (g.gather() if isinstance(g, sharding.UpdateBlock)
                     else g).detach().clone() for k, g in tree.items()}
        records.append({"grads": whole, "norm": norm.detach().clone(),
                        "whole_norm": steps._global_norm(whole)})
        return orig(tree, norm, max_norm)

    steps._clip = spy
    try:
        yield records
    finally:
        steps._clip = orig


def clip_scale(norm, max_norm: float = 1.0) -> torch.Tensor:
    """The train step's clip factor of ``norm`` (``train.steps._clip``)."""
    return torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)


def placed_run(opt_name: str, zero_mode: str, steps: int = MESH_STEPS,
               microbatch: int = 0, state=None, start: int = 0,
               arch: str = TRAIN["arch"], remat: bool | None = None):
    """``steps`` train steps of ``arch``'s smoke model (the llama by
    default; ``microbatch`` rows a microbatch, 0: the whole batch) from
    step ``start`` of ``state`` (None: ``init_state``), on the active mesh
    under the active policy or on one process: losses, the last state
    (gathered whole), its placements and the held state."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.optim.api import get_optimizer
    from repro_torch.parallel import sharding
    from repro_torch.parallel.zero import ZeroConfig
    from repro_torch.train.steps import init_state, make_train_step

    name, kw = MESH_OPTS[opt_name]
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              train_microbatch=microbatch)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    zero = ZeroConfig(zero_mode)
    opt = get_optimizer(name, lr=0.01, zero=zero, **kw)
    # guarded: on a mesh the ranks combine their blocks' finite flags
    step = make_train_step(cfg, opt, guard=True)
    batch_fn = make_batch_fn(cfg, TRAIN["seq"], TRAIN["batch"], seed=0,
                             device="cpu")
    if state is None:
        state = init_state(cfg, opt, 0, "cpu")
    losses, clips = [], []
    with clip_spy(clips):
        for t in range(start, start + steps):
            state, metrics = step(state, batch_fn(t))
            losses.append(float(metrics["loss"]))
    mesh, specs, whole = sharding.active_mesh(), None, state
    if mesh is not None:
        with sharding.set_mesh(None):
            abstract = init_state(cfg, opt, 0, "meta")
        specs = sharding.train_state_specs(abstract, zero=zero, mesh=mesh)
        whole = sharding.gather_tree(state, specs, mesh)
    return {"losses": losses, "whole": whole, "specs": specs,
            "held": state, "opt": opt, "cfg": cfg, "clips": clips}


def run_record(run) -> dict:
    """What a placed run hands the test: losses, the whole parameters and
    optimizer state, the bytes each rank holds (per parameter leaf: held,
    whole and the blocks it is cut into), and each step's clip: the
    whole gradients before it (``pre_clip``) and ``norms`` (the step's,
    the whole gradients' one-process norm)."""
    from repro_torch.parallel import sharding

    out = {"losses": torch.tensor(run["losses"], dtype=torch.float64),
           "params": dict(run["whole"].params),
           "opt_state": flat_tensors(run["whole"].opt_state),
           "pre_clip": [c["grads"] for c in run["clips"]],
           "norms": torch.tensor([[float(c["norm"]), float(c["whole_norm"])]
                                  for c in run["clips"]])}
    specs, mesh = run["specs"], sharding.active_mesh()
    if specs is not None:
        leaves = {}
        for k, t in run["held"].params.items():
            n = 1
            for _, _, b in specs.params[k].splits(mesh):
                n *= b
            held, whole = sharding.state_bytes({k: t}, {k: specs.params[k]},
                                               mesh)
            leaves[k] = torch.tensor([held, whole, n])
        out["param_bytes"] = leaves
        out["opt_bytes"] = torch.tensor(sharding.state_bytes(
            run["held"].opt_state, specs.opt_state, mesh))
    return out


def decode_logits(arch: str, layout: str):
    """One ``decode_step`` of ``arch``'s smoke model (batch 4, position
    0) on parameters placed under ``layout`` on the active mesh and
    gathered back: the logits and the held / whole parameter bytes."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding

    cfg = get_config(arch, smoke=True) if isinstance(arch, str) else arch
    params = T.init_params(cfg, 3, "cpu")
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (4,)))
    mesh = sharding.active_mesh()
    nbytes = None
    with sharding.use_policy(layout=layout):
        if mesh is not None:
            specs = sharding.params_specs(params, mesh)
            held = sharding.shard_tree(params, specs, mesh)
            nbytes = torch.tensor(sharding.state_bytes(held, specs, mesh))
            params = sharding.gather_tree(held, specs, mesh)
        with torch.no_grad():
            logits, _ = T.decode_step(params, T.init_cache(cfg, 4, 16, "cpu"),
                                      tok, 0, cfg)
    return {"logits": logits, "bytes": nbytes}


def clipped_adam_updates(steps: int = 2) -> list:
    """Full-rank Adam on every leaf of the smoke llama, then the global-norm
    clip (on the active mesh: the moments held as blocks, the clip's norm
    summed across them): the whole updates of each step."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.optim.transform import (as_optimizer, chain,
                                             clip_global_norm, scale_by_adam)
    from repro_torch.parallel.zero import gather_updates

    params = T.init_params(get_config(TRAIN["arch"], smoke=True), 0, "cpu")
    opt = as_optimizer(chain(scale_by_adam(), clip_global_norm(1e-3)))
    state, out = opt.init(params), []
    for t in range(steps):
        rng = np.random.default_rng(50 + t)
        g = {k: torch.from_numpy(rng.standard_normal(tuple(p.shape))
                                 .astype(np.float32))
             for k, p in params.items()}
        u, state = opt.update(g, state, params)
        out.append(gather_updates(u))
    return out


# ---------------------------------------------------------------------------
# the models' mesh bodies (tests/test_torch_mesh_models.py): MoE routing on
# a data mesh, expert-parallel moe_ffn, decode_tp's f-cut experts and
# sequence-parallel attention, on the same worlds
# ---------------------------------------------------------------------------
# a tiny MoE (the reference's tests/test_multidevice.py case) whose
# capacity factor 1.0 drops tokens
TINY_MOE = dict(name="tinymoe", family="moe", d_model=32, n_heads=4,
                n_kv_heads=2, d_ff=64, vocab_size=64,
                schedule=((("attn", "attn_moe"), 2),), n_experts=4,
                moe_top_k=2, moe_d_ff=16, capacity_factor=1.0,
                param_dtype="float32", compute_dtype="float32", remat=False,
                q_chunk=16, kv_chunk=16)
ROUTE_BATCH, ROUTE_SEQ = 8, 16
ROUTE_MICRO = 4             # two global microbatches of 4 rows
# a tiny dense model with a sequence long enough for SP at tp 2 (S/tp >= 64)
TINY_SP = dict(name="tiny", family="dense", d_model=32, n_heads=4,
               n_kv_heads=2, d_ff=64, vocab_size=64,
               schedule=((("attn",), 2),), param_dtype="float32",
               compute_dtype="float32", remat=False, q_chunk=32,
               kv_chunk=32)
SP_BATCH, SP_SEQ = 4, 128
# SP attention cases: (b, s, skv, hq, hkv, hd, vd, causal, window); the
# reference's heads (6 / 3 of 16: neither divides tp) at S = 128, an
# MLA-shaped one (v dim != qk dim) and a cross-attention (keys of their
# own length)
SP_CASES = {"causal": (2, 128, 128, 6, 3, 16, 16, True, None),
            "window": (2, 128, 128, 6, 3, 16, 16, True, 40),
            "mla": (2, 128, 128, 4, 4, 24, 16, True, None),
            "cross": (2, 128, 40, 6, 3, 16, 16, False, None)}
SP_CHUNKS = dict(q_chunk=32, kv_chunk=32)
EP_SHAPE = (4, 8)           # moe_ffn's direct calls: B, S
EP_ARCH = "deepseek-moe-16b"


def tiny_cfg(fields: dict, **kw):
    from repro_torch.models.config import ModelConfig

    return ModelConfig(**{**fields, **kw})


def route_batch() -> dict:
    rng = np.random.default_rng(11)
    toks = rng.integers(0, TINY_MOE["vocab_size"],
                        (ROUTE_BATCH, ROUTE_SEQ + 1))
    return {"tokens": torch.from_numpy(toks[:, :-1]).long(),
            "targets": torch.from_numpy(toks[:, 1:]).long()}


def sp_batch() -> dict:
    rng = np.random.default_rng(12)
    toks = rng.integers(0, TINY_SP["vocab_size"], (SP_BATCH, SP_SEQ + 1))
    return {"tokens": torch.from_numpy(toks[:, :-1]).long(),
            "targets": torch.from_numpy(toks[:, 1:]).long()}


class GradCapture:
    """An optimizer whose update is the negated gradient it is handed (the
    step's averaged, unclipped gradient), kept in ``grads``."""

    def __init__(self):
        self.grads = None

    def init(self, params):
        return ()

    def update(self, grads, state, params):
        from repro_torch.parallel import sharding

        # a train step under a mesh hands the split leaves' gradients as
        # this rank's blocks (``sharding.Block``): kept whole here
        self.grads = {k: (g.gather() if isinstance(g, sharding.Block)
                          else g).detach().clone() for k, g in grads.items()}
        return {k: -g for k, g in grads.items()}, state


def captured_step(cfg, params: dict, batch: dict) -> dict:
    """One train step (no clipping) of ``cfg`` from ``params`` on the
    active mesh (the parameters placed under the active policy) or on one
    process: its loss, ce and the gradient it hands the optimizer."""
    from repro_torch.parallel import sharding
    from repro_torch.train.steps import TrainState, make_train_step

    opt = GradCapture()
    mesh = sharding.active_mesh()
    held = params if mesh is None else sharding.shard_tree(
        params, sharding.params_specs(params, mesh), mesh)
    _, m = make_train_step(cfg, opt, grad_clip=0.0)(
        TrainState(0, held, ()), batch)
    return {"loss": m["loss"], "ce": m["ce"], "grads": opt.grads}


def ranks_equal(tensors: list, axes) -> bool:
    """Whether every rank over ``axes`` holds the same bits."""
    from repro_torch.parallel import sharding

    mesh = sharding.active_mesh()
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    parts = mesh.all_gather(flat, tuple(axes))
    return all(torch.equal(p, parts[0]) for p in parts)


def routing_run(mesh=None) -> dict:
    """TINY_MOE's train step on the whole batch and in ROUTE_MICRO-row
    global microbatches, on ``mesh`` (a data mesh) or one process; with
    ``mesh`` also the forward's ``moe_aux`` on this rank's rows."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding

    out = {}
    batch = route_batch()
    for mb in (0, ROUTE_MICRO):
        cfg = tiny_cfg(TINY_MOE, train_microbatch=mb)
        params = T.init_params(cfg, 0, "cpu")
        with sharding.set_mesh(mesh):
            out[f"mb{mb}"] = captured_step(cfg, params, batch)
            if mb == 0:
                axes = mesh.axis_names if mesh is not None else ()
                rows = batch["tokens"]
                if mesh is not None:
                    n = mesh.size(axes)
                    per = rows.shape[0] // n
                    rows = rows[mesh.shard_index(axes) * per:][:per]
                with sharding.batch_cut(axes), torch.no_grad():
                    _, aux = T.forward(params, {"tokens": rows}, cfg)
                out["aux"] = aux["moe_aux"]
    return out


def moe_inputs(dtype=torch.float32) -> tuple[dict, torch.Tensor,
                                              torch.Tensor]:
    """TINY_MOE's ``moe/`` leaves with two shared experts, x (EP_SHAPE) and
    the loss weights, all drawn by numpy."""
    from repro_torch.models.moe import init_moe

    cfg = tiny_cfg(TINY_MOE, n_shared_experts=2, shared_d_ff=32)
    rng = np.random.default_rng(21)
    meta = init_moe(None, cfg, device="meta")
    p = {k: torch.from_numpy(rng.normal(0.0, m.shape[-2] ** -0.5, m.shape)
                             .astype(np.float32)).to(dtype)
         for k, m in meta.items()}
    x = torch.from_numpy(rng.standard_normal((*EP_SHAPE, cfg.d_model))
                         .astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((*EP_SHAPE, cfg.d_model))
                         .astype(np.float32))
    return p, x, w


def moe_grads(p: dict, x, w) -> dict:
    """``moe_ffn``'s output and aux on whole inputs (on the active mesh:
    every rank its share, the results whole), and the gradients of
    ``sum(out * w) + aux`` w.r.t. x and every leaf."""
    from repro_torch.models.moe import moe_ffn

    cfg = tiny_cfg(TINY_MOE, n_shared_experts=2, shared_d_ff=32)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xg = x.clone().requires_grad_(True)
    out, aux = moe_ffn(leaves, xg, cfg)
    loss = (out.float() * w).sum() + aux
    g = torch.autograd.grad(loss, [xg, *leaves.values()])
    return {"out": out.detach(), "aux": aux.detach(),
            "grads": dict(zip(["x", *leaves], g))}


def sp_inputs(case: str) -> tuple:
    b, s, skv, hq, hkv, hd, vd, causal, window = SP_CASES[case]
    rng = np.random.default_rng(31)
    q, k, v, w = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((b, s, hq, hd), (b, skv, hkv, hd),
                                   (b, skv, hkv, vd), (b, s, hq, vd)))
    return q, k, v, w, dict(causal=causal, window=window)


def sp_grads(case: str) -> dict:
    """``sp_blockwise_attention`` on whole inputs (on the active mesh),
    and the gradients of ``sum(out * w)`` w.r.t. q, k, v."""
    from repro_torch.models.layers import sp_blockwise_attention

    q, k, v, w, kw = sp_inputs(case)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    out = sp_blockwise_attention(q, k, v, **kw, **SP_CHUNKS)
    g = torch.autograd.grad((out * w).sum(), [q, k, v])
    return {"out": out.detach(), "grads": dict(zip("qkv", g))}


def sp_route() -> dict:
    """SP prefills (no grad) with the route's device test patched to say
    "card" and recorders in place of the launchers: each call's (kernel,
    rows, q_offset) and the outputs."""
    import importlib

    from repro_torch.models import layers as TL

    fa = importlib.import_module("repro_torch.kernels.flash_attention")

    calls, saved = [], (TL._on_card, TL.flash_attention_blockwise,
                        TL.flash_attention_op)

    def rec(name, fn):
        def launcher(q, k, v, **kw):
            calls.append([name, q.shape[1], kw["q_offset"]])
            return fn(q, k, v, **kw)
        return launcher

    TL._on_card = lambda t: True
    TL.flash_attention_blockwise = rec("blockwise",
                                       fa.flash_attention_blockwise)
    TL.flash_attention_op = rec("flash", fa.flash_attention)
    out = {}
    try:
        q, k, v, _, kw = sp_inputs("window")
        with torch.inference_mode():
            out["bf16"] = TL.sp_blockwise_attention(
                q.bfloat16(), k.bfloat16(), v.bfloat16(), **kw, **SP_CHUNKS)
            out["fp32"] = TL.sp_blockwise_attention(q, k, v, **kw,
                                                    **SP_CHUNKS)
    finally:
        TL._on_card, TL.flash_attention_blockwise, TL.flash_attention_op = \
            saved
    # every model rank's calls, in shard order: (kernel 0 blockwise / 1
    # flash, query rows, q_offset)
    from repro_torch.parallel import sharding

    mine = torch.tensor([[0 if c[0] == "blockwise" else 1, c[1], c[2]]
                         for c in calls])
    out["calls"] = torch.stack(sharding.active_mesh().all_gather(
        mine, ("model",)))
    return out


def sp_step(attn_sp: bool) -> dict:
    """TINY_SP's train step (attn_sp on or off) on the active mesh."""
    from repro_torch.models import transformer as T

    cfg = tiny_cfg(TINY_SP, attn_sp=attn_sp)
    return captured_step(cfg, T.init_params(cfg, 0, "cpu"), sp_batch())


def _model_mesh_results(mesh, key: str) -> dict:
    """The mesh bodies on one (data, model) mesh."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding

    out = {}
    allax = mesh.axis_names
    with sharding.set_mesh(mesh):
        p, x, w = moe_inputs()
        r = moe_grads(p, x, w)
        r["ranks_equal"] = torch.tensor(ranks_equal(
            [r["out"], r["aux"], *r["grads"].values()], allax))
        out[f"ep/{key}"] = r
        for case in SP_CASES:
            r = sp_grads(case)
            r["ranks_equal"] = torch.tensor(ranks_equal(
                [r["out"], *r["grads"].values()], allax))
            out[f"sp/{key}/{case}"] = r
        out[f"sp_route/{key}"] = sp_route()
        for on in (False, True):
            r = sp_step(on)
            r["ranks_equal"] = torch.tensor(ranks_equal(
                list(r["grads"].values()), allax))
            out[f"sp_step/{key}/{on}"] = r
        for zm in ("off", "1"):
            run = placed_run("dct_adamw", zm, arch=EP_ARCH)
            out[f"ep_step/{key}/{zm}"] = run_record(run)
        cfg = tiny_cfg(TINY_MOE, capacity_factor=8.0)
        for layout in ("fsdp_tp", "decode_tp"):
            out[f"decode/{key}/tinymoe/{layout}"] = decode_logits(cfg,
                                                                  layout)
        # with remat: the checkpointed blocks recompute their collectives
        cfg = tiny_cfg(TINY_MOE, remat=True)
        r = captured_step(cfg, T.init_params(cfg, 0, "cpu"), route_batch())
        r["ranks_equal"] = torch.tensor(ranks_equal(
            list(r["grads"].values()), ("model",)))
        out[f"ep_grads/{key}"] = r
    return out


def _mesh_results(world: int, tmp: str) -> dict:
    """The placed train state on this world's (data, model) meshes."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding
    from repro_torch.train.checkpoint import CheckpointManager

    out = {}
    ckpt = os.path.join(os.path.dirname(tmp), "mesh_ckpt")
    for shape in MESHES[world]:
        mesh = make_mesh(shape, ("data", "model"))
        key = mesh_key(shape)
        with sharding.set_mesh(mesh):
            for opt_name in MESH_OPTS:
                for zm in ("off", "1"):
                    run = placed_run(opt_name, zm)
                    out[f"mesh/{key}/{opt_name}/{zm}/fsdp_tp"] = \
                        run_record(run)
                    if shape == (2, 2) and (opt_name, zm) == MESH_CKPT:
                        out["mesh/ckpt_saved"] = flat_tensors(run["whole"])
                        if mesh.rank == 0:
                            CheckpointManager(ckpt).save(MESH_STEPS,
                                                         run["whole"])
            for opt_name, zm in PURE_DP:
                with sharding.use_policy(layout="pure_dp"):
                    out[f"mesh/{key}/{opt_name}/{zm}/pure_dp"] = \
                        run_record(placed_run(opt_name, zm))
            out[f"mesh/{key}/clip"] = clipped_adam_updates()
            for arch in DECODE_ARCHS:
                for layout in ("fsdp_tp", "decode_tp"):
                    out[f"mesh/{key}/decode/{arch}/{layout}"] = \
                        decode_logits(arch, layout)
            if shape == (1, 2):
                out["mesh/restore"] = _restore_at(mesh, ckpt)
        out.update(_model_mesh_results(mesh, key))
        out.update(_fsdp_results(mesh, key))
        if shape in MEG_MESHES[world]:
            out.update(_megatron_results(mesh, key))
    for shape in MEG_MESHES[world]:
        if shape not in MESHES[world]:
            out.update(_megatron_results(make_mesh(shape, ("data", "model")),
                                         mesh_key(shape)))
    # the routing fault's case: a data-only mesh of the whole world
    data_mesh = make_mesh((world,), ("data",))
    out["route"] = routing_run(data_mesh)
    with sharding.set_mesh(data_mesh):
        out[f"meg/{mesh_key((world,))}/zero_rows"] = zero_rows()
    if world == 2:
        out.update(_fsdp_results(data_mesh, mesh_key((world,))))
    return out


# ---------------------------------------------------------------------------
# FSDP's schedule (tests/test_torch_fsdp.py): the gathers a step makes, the
# whole bytes alive at once, remat, the microbatched step and both routes of
# the gradients' reduction, on the same worlds
# ---------------------------------------------------------------------------
FSDP_MICRO = 1              # rows a microbatch of the microbatched step


def fsdp_grads(cfg, mesh) -> dict:
    """``parallel.fsdp.grad_fn`` of ``cfg``'s smoke-size parameters (seed
    0) on the step's batch cut, with a spy on ``Mesh.all_gather_many``:
    the Held's log of gathers, its live-byte peak, every all-gather's
    bytes, the split leaves and their whole bytes, and whether each
    gradient has its block's shape."""
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.models import transformer as T
    from repro_torch.parallel import fsdp, sharding
    from repro_torch.train.steps import loss_fn

    sizes, orig = [], type(mesh).all_gather_many

    def spy(self, tensors, axes):
        parts = orig(self, tensors, axes)
        sizes.append(sum(t.numel() * t.element_size() for row in parts
                         for t in row))
        return parts

    with sharding.set_mesh(mesh):
        whole = T.init_params(cfg, 0, "meta")
        specs = sharding.params_specs(whole, mesh)
        params = sharding.shard_tree(T.init_params(cfg, 0, "cpu"), specs,
                                     mesh)
        batch = make_batch_fn(cfg, TRAIN["seq"], TRAIN["batch"], seed=0,
                              device="cpu")(0)
        b_specs = sharding.batch_specs_tree(batch)
        dp = tuple(a for _, axes, _ in b_specs["tokens"].splits(mesh)
                   for a in axes)
        type(mesh).all_gather_many = spy
        try:
            with sharding.batch_cut(dp):
                grads, _, held = fsdp.grad_fn(
                    params, specs, whole, mesh, dp, torch.float32,
                    loss_fn, sharding.shard_tree(batch, b_specs), cfg)
        finally:
            type(mesh).all_gather_many = orig
    split = sorted(k for k, s in specs.items() if s.splits(mesh))
    return {"log": [[e["phase"], e["tag"], list(e["axes"]), e["paths"],
                     e["bytes"]] for e in held.log if "route" not in e],
            "megatron": sorted({p for e in held.log
                                if e.get("route") == "megatron"
                                for p in e["paths"]}),
            "peak_live": held.peak_live_bytes, "live_after": held.live_bytes,
            "gather_bytes": sizes, "split": split,
            "whole_bytes": {k: whole[k].numel() * whole[k].element_size()
                            for k in whole},
            "block_shapes": all(tuple(grads[k].shape) == tuple(p.shape)
                                for k, p in params.items())}


def _fsdp_results(mesh, key: str) -> dict:
    """FSDP's schedule on one mesh (module constants)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding

    out = {}
    for remat in (False, True):
        out[f"fsdp/{key}/spy/moe/{remat}"] = fsdp_grads(
            tiny_cfg(TINY_MOE, remat=remat), mesh)
    out[f"fsdp/{key}/spy/llama/True"] = fsdp_grads(
        dataclasses.replace(get_config(TRAIN["arch"], smoke=True),
                            remat=True), mesh)
    with sharding.set_mesh(mesh):
        for zm in ("off", "1"):
            out[f"fsdp/{key}/remat/{zm}"] = run_record(
                placed_run("dct_adamw", zm, remat=True))
        if "model" in mesh.axis_names:
            out[f"fsdp/{key}/ep_remat"] = run_record(
                placed_run("dct_adamw", "off", arch=EP_ARCH, remat=True))
        # the gradients' reduction as an all-reduce and a cut
        mesh.reduce_scatter, saved = False, mesh.reduce_scatter
        try:
            out[f"fsdp/{key}/all_reduce_route"] = run_record(
                placed_run("dct_adamw", "off"))
        finally:
            mesh.reduce_scatter = saved
        cfg = get_config(TRAIN["arch"], smoke=True)
        params = T.init_params(cfg, 0, "cpu")
        batch = make_batch(cfg)
        for mb in (0, FSDP_MICRO):
            out[f"fsdp/{key}/micro/{mb}"] = captured_step(
                dataclasses.replace(cfg, train_microbatch=mb), params, batch)
    return out


def make_batch(cfg) -> dict:
    """The smoke llama's first batch of the placed runs."""
    from repro_torch.data.synthetic import make_batch_fn

    return make_batch_fn(cfg, TRAIN["seq"], TRAIN["batch"], seed=0,
                         device="cpu")(0)


def _restore_at(mesh, ckpt: str) -> dict:
    """(2, 2)'s checkpoint restored on ``mesh``: the restored state
    gathered whole, then one more step."""
    from repro_torch.parallel import sharding
    from repro_torch.train.checkpoint import CheckpointManager

    ok = os.path.join(ckpt, f"step_{MESH_STEPS}", "OK")
    t0 = time.time()
    while not os.path.exists(ok):
        if time.time() - t0 > 240:
            raise TimeoutError("no checkpoint from the world of 4")
        time.sleep(0.1)
    target = placed_run(*MESH_CKPT, steps=0)
    state = CheckpointManager(ckpt).restore(MESH_STEPS, target["held"],
                                            target["specs"])
    restored = sharding.gather_tree(state, target["specs"], mesh)
    run = placed_run(*MESH_CKPT, steps=1, state=state, start=MESH_STEPS)
    return {"restored": flat_tensors(restored), "next": run_record(run)}


def _results(world: int, shape, axes, tmp: str) -> dict:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.api import get_optimizer
    from repro_torch.parallel import sharding
    from repro_torch.parallel.zero import ZeroConfig, gather_updates
    from repro_torch.telemetry.stats import collect
    from repro_torch.train.checkpoint import CheckpointManager

    zero = ZeroConfig("1")
    mesh = make_mesh(shape, axes)
    out = {}
    ckpt = os.path.join(os.path.dirname(tmp), "ckpt")
    with sharding.set_mesh(mesh):
        if world == 4:
            # the checkpoint first: the world of 2 restores it
            name, kw = CASES[CKPT_CASE]
            _, st, _ = run_case(name, kw, CKPT_STEP, zero)
            if mesh.rank == 0:
                CheckpointManager(ckpt).save(CKPT_STEP, st)
            out["ckpt/state"] = flat_tensors(st)
        for cid, (name, kw) in CASES.items():
            ups, st, held = run_case(name, kw, zero=zero)
            out[f"case/{cid}"] = {"updates": ups, "state": flat_tensors(st),
                                  "held": torch.tensor(held)}
        for cid, (name, kw) in TELEMETRY.items():
            opt = get_optimizer(name, lr=0.01, zero=zero, **kw)
            params = params_t()
            st = opt.init(params)
            stats = []
            for t in range(TELEMETRY_STEPS):
                g = {k: torch.from_numpy(v) for k, v in
                     grads_np(t, case_rank(kw)).items()}
                with collect() as col:
                    _, st = opt.update(g, st, params)
                stats.append({f"{p}/{f}": getattr(s, f)
                              for p, s in col.tree().items()
                              for f in s._fields})
            out[f"telemetry/{cid}"] = stats
        if world == 2:
            losses, params, opt_state = train_run(zero)
            out["train"] = {"losses": torch.tensor(losses), "params": params,
                            "opt_state": flat_tensors(opt_state)}
            # restore the world of 4's checkpoint, one more update
            ok = os.path.join(ckpt, f"step_{CKPT_STEP}", "OK")
            t0 = time.time()
            while not os.path.exists(ok):
                if time.time() - t0 > 240:
                    raise TimeoutError("no checkpoint from the world of 4")
                time.sleep(0.1)
            name, kw = CASES[CKPT_CASE]
            opt = get_optimizer(name, lr=0.01, zero=zero, **kw)
            params = params_t()
            target = opt.init(params)
            st = CheckpointManager(ckpt).restore(
                CKPT_STEP, target, sharding.optimizer_state_specs(
                    opt, params, zero=zero, mesh=mesh))
            g = {k: torch.from_numpy(v) for k, v in
                 grads_np(CKPT_STEP, case_rank(kw)).items()}
            u, _ = opt.update(g, st, params)
            out["ckpt/update"] = gather_updates(u)
            out["ckpt/held_rows"] = torch.tensor(
                st.leaves[0]["lowrank"]["w"].m.shape[-2])
    out.update(_mesh_results(world, tmp))
    return out


def worker(rank: int, world: int, shape, axes, tmp: str) -> None:
    """One rank: the process group from ``tmp``'s file store, the world's
    results, rank 0 writing them."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                                rank=rank, world_size=world)
        out = _results(world, shape, axes, tmp)
        if rank == 0:
            torch.save(out, os.path.join(tmp, "results.pt.tmp"))
            os.replace(os.path.join(tmp, "results.pt.tmp"),
                       os.path.join(tmp, "results.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


# the two worlds: 2 ranks over ("data",), 4 over ("pod", "data")
WORLDS = {2: ((2,), ("data",)), 4: ((2, 2), ("pod", "data"))}


def worlds_root(tmp_path_factory) -> str:
    """Where the run's one spawn of the worlds lives: the base temp shared
    by the pytest-xdist workers of the run (the workers' own temps' parent),
    else the run's base temp. ``test_torch_zero.py`` and
    ``test_torch_mesh_models.py`` both read these worlds."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    return os.path.join(str(base), "torch_gloo_worlds")


def start_worlds(root: str):
    """Spawn both worlds once a run: the first caller (who creates
    ``root/spawned``) starts them and gets ``{world: processes}``, later
    callers None."""
    os.makedirs(root, exist_ok=True)
    try:
        fd = os.open(os.path.join(root, "spawned"),
                     os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return None
    os.close(fd)
    return {w: spawn(w, shape, axes, os.path.join(root, f"w{w}"))
            for w, (shape, axes) in WORLDS.items()}


def world_results(root: str, procs, timeout: float = 600.0) -> dict:
    """``{world: rank 0's results}``: joined here where this process
    spawned them (``procs``), else waited for (rank 0's file, or any
    rank's traceback)."""
    if procs is not None:
        return {w: join(p, os.path.join(root, f"w{w}"), timeout)
                for w, p in procs.items()}
    deadline = time.time() + timeout
    out = {}
    for w in WORLDS:
        tmp = os.path.join(root, f"w{w}")
        while not os.path.exists(os.path.join(tmp, "results.pt")):
            errs = [f for f in (os.listdir(tmp) if os.path.isdir(tmp)
                                else ()) if f.endswith(".err")]
            if errs:
                time.sleep(1.0)     # the tracebacks finish writing
                raise RuntimeError("ranks failed:\n" + "".join(
                    open(os.path.join(tmp, f)).read() for f in sorted(errs)))
            if time.time() > deadline:
                raise TimeoutError(f"no results from the world of {w}")
            time.sleep(0.2)
        out[w] = torch.load(os.path.join(tmp, "results.pt"))
    return out


def spawn(world: int, shape, axes, tmp: str) -> list:
    """Start the world's ranks (``spawn``: fresh interpreters)."""
    import multiprocessing

    os.makedirs(tmp, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker, args=(r, world, shape, axes, tmp))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join(procs: list, tmp: str, timeout: float = 300.0) -> dict:
    """Wait for the ranks (killing them past ``timeout``) and load rank
    0's results; raise with the ranks' tracebacks if one failed."""
    deadline = time.time() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.time()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    errs = "".join(open(os.path.join(tmp, f)).read()
                   for f in sorted(os.listdir(tmp)) if f.endswith(".err"))
    if alive or any(p.exitcode for p in procs) or errs:
        raise RuntimeError(f"ranks failed (exit codes "
                           f"{[p.exitcode for p in procs]}):\n{errs}")
    return torch.load(os.path.join(tmp, "results.pt"))


# ---------------------------------------------------------------------------
# Megatron's column / row compute (tests/test_torch_megatron.py): the dense
# attention and MLP products on each rank's model block, the two MoE
# layouts that gather rows, the clip's norm from block sums and ZeRO's rows
# from the blocks, on the same worlds
# ---------------------------------------------------------------------------
MEG_DENSE = dict(family="dense", d_model=32, n_heads=4, n_kv_heads=2,
                 d_ff=64, vocab_size=64, schedule=((("attn",), 2),),
                 param_dtype="float32", compute_dtype="float32",
                 remat=False, q_chunk=16, kv_chunk=16)
# name -> (the fields over ``base``: a ModelConfig's own, or a registry
# arch's smoke config)
MEG_CASES = {
    "llama": (None, dict(MEG_DENSE, name="tinyllama")),
    # qkv bias and qk-norm scales beside a group of 2
    "qwen": (None, dict(MEG_DENSE, name="tinyqwen", qkv_bias=True,
                        use_qk_norm=True)),
    # enc / dec / cross attention with biases, the GELU MLP
    "whisper": ("whisper-large-v3", dict(d_model=32, n_heads=4,
                                         n_kv_heads=4, d_ff=64,
                                         vocab_size=64, encoder_seq=16,
                                         q_chunk=16, kv_chunk=16)),
    # shared experts on the MLP's route (no drops: capacity 8)
    "moe": (None, dict(TINY_MOE, n_shared_experts=1, shared_d_ff=32,
                       capacity_factor=8.0)),
}
MEG_MESHES = {2: ((1, 2),), 4: ((2, 2), (1, 4))}
MEG_BATCH, MEG_SEQ, MEG_RANK, MEG_LR = 4, 16, 16, 0.01
# the two MoE layouts that gather rows: TINY_MOE (drops) under each
MEG_MOE_LAYOUTS = ("pure_dp", "decode_tp")


def meg_cfg(name: str):
    import dataclasses

    from repro_torch.configs.registry import get_config

    arch, fields = MEG_CASES[name]
    if arch is None:
        return tiny_cfg(fields)
    return dataclasses.replace(get_config(arch, smoke=True), **fields)


def meg_params(cfg) -> dict:
    """``cfg``'s parameters drawn by numpy, one stream a leaf (seeded by
    its path): matrices N(0, 1/d_in), embeddings N(0, 0.02^2), biases
    N(0, 0.1^2), layer-norm scales 1 + N(0, 0.1^2), RMS-norm scales and
    gates N(0, 0.1^2) (the RMS norm's gain is 1 + scale)."""
    from repro_torch.models import transformer as T

    out = {}
    for k, m in T.init_params(cfg, 0, "meta").items():
        rng = np.random.default_rng(zlib.crc32(k.encode()))
        shape = tuple(m.shape)
        name = k.rsplit("/", 1)[-1]
        if name == "bias" or "gate" in name or "norm" in k or "ln" in k:
            v = rng.normal(0.0, 0.1, shape)
            if name == "scale" and cfg.family == "encdec":
                v = 1.0 + v
        elif "embed" in k:
            v = rng.normal(0.0, 0.02, shape)
        else:
            v = rng.normal(0.0, shape[-2] ** -0.5, shape)
        out[k] = torch.from_numpy(v.astype(np.float32)).to(m.dtype)
    return out


def meg_batch(cfg) -> dict:
    rng = np.random.default_rng(41)
    toks = rng.integers(0, cfg.vocab_size, (MEG_BATCH, MEG_SEQ + 1))
    out = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
           "targets": torch.from_numpy(toks[:, 1:]).long()}
    if cfg.encoder_layers:
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (MEG_BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return out


@contextlib.contextmanager
def held_spy(helds: list):
    """Keep the ``parallel.fsdp.Held`` of each ``fsdp.grad_fn`` call."""
    from repro_torch.parallel import fsdp

    orig = fsdp.grad_fn

    def spy(*a, **kw):
        g, m, held = orig(*a, **kw)
        helds.append(held)
        return g, m, held

    fsdp.grad_fn = spy
    try:
        yield helds
    finally:
        fsdp.grad_fn = orig


@contextlib.contextmanager
def product_spy(shapes: set):
    """Record the weight shape of every ``layers.matmul`` (the models'
    dense products)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    orig = L.matmul

    def spy(x, w):
        shapes.add(tuple(w.shape))
        return orig(x, w)

    L.matmul = T.matmul = spy
    try:
        yield shapes
    finally:
        L.matmul = T.matmul = orig


def meg_logits(cfg, params: dict, batch: dict):
    """The no-grad forward of ``cfg`` on the active mesh, each use site
    handed as the train step hands it (``fsdp.Held.use``) on this rank's
    rows; the logits of every rank gathered."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel import fsdp, sharding

    mesh = sharding.active_mesh()
    whole = T.init_params(cfg, 0, "meta")
    specs = sharding.params_specs(whole, mesh)
    blocks = sharding.shard_tree(params, specs, mesh)
    b_specs = sharding.batch_specs_tree(batch)
    dp = tuple(a for _, axes, _ in b_specs["tokens"].splits(mesh)
               for a in axes)
    rows = sharding.shard_tree(batch, b_specs)
    held = fsdp.Held(blocks, specs, whole, mesh, dp, torch.float32,
                     lambda path, t: T.cast_dtype(path, t, cfg))
    with torch.no_grad(), sharding.batch_cut(dp):
        logits, _ = T.forward(blocks, {k: v for k, v in rows.items()
                                       if k != "targets"}, cfg,
                              use=held.use)
    return torch.cat(mesh.all_gather(logits.contiguous(), dp)) if dp \
        else logits


def megatron_case(name: str) -> dict:
    """One DCT-AdamW step of ``MEG_CASES[name]`` on the active mesh: loss,
    the whole parameters after it, the gradients before the clip, the
    norms, the no-grad forward's logits, each site's route, every
    gather, the products' weight shapes."""
    from repro_torch.optim.api import get_optimizer
    from repro_torch.parallel import sharding
    from repro_torch.train.steps import TrainState, make_train_step

    cfg = meg_cfg(name)
    params, batch = meg_params(cfg), meg_batch(cfg)
    mesh = sharding.active_mesh()
    opt = get_optimizer("dct_adamw", lr=MEG_LR, rank=MEG_RANK)
    specs = sharding.params_specs(params, mesh)
    state = TrainState(0, sharding.shard_tree(params, specs, mesh),
                       opt.init(params))
    clips, helds, shapes = [], [], set()
    with clip_spy(clips), held_spy(helds), product_spy(shapes):
        state, m = make_train_step(cfg, opt)(state, batch)
    held = helds[0]
    return {"loss": m["loss"], "grad_norm": m["grad_norm"],
            "params": sharding.gather_tree(state.params, specs, mesh),
            "pre_clip": clips[0]["grads"],
            "norms": torch.tensor([float(clips[0]["norm"]),
                                   float(clips[0]["whole_norm"])]),
            "logits": meg_logits(cfg, params, batch),
            "routes": [[e["phase"], e["tag"], e["group"], e["route"],
                        e["why"] or "", e["paths"]]
                       for e in held.log if "route" in e],
            "gathers": [[e["phase"], e["tag"], list(e["axes"]), e["paths"],
                         e["bytes"]] for e in held.log if "route" not in e],
            "shapes": sorted(shapes),
            "peak_live": held.peak_live_bytes}


def moe_layout_case(layout: str) -> dict:
    """TINY_MOE's train step (drops; no clipping) under ``layout`` on the
    active mesh: the loss and the whole gradient."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding

    cfg = tiny_cfg(TINY_MOE)
    with sharding.use_policy(layout=layout):
        return captured_step(cfg, T.init_params(cfg, 0, "cpu"),
                             route_batch())


def zero_rows() -> dict:
    """DCT-AdamW with ZeRO-1 on the smoke llama's gradients handed as the
    train step hands them (``sharding.Block`` s of its placements), two
    updates against the replicated optimizer on the whole gradients (no
    mesh): updates and selections compared bit for bit, the gathers of a
    whole leaf counted (``sharding.gather``) and the collectives' bytes
    (``Mesh.counts``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.optim.api import get_optimizer
    from repro_torch.parallel import sharding
    from repro_torch.parallel.zero import ZeroConfig
    from repro_torch.train.checkpoint import tree_items

    mesh = sharding.active_mesh()
    params = T.init_params(get_config(TRAIN["arch"], smoke=True), 0, "cpu")
    specs = sharding.params_specs(params, mesh)
    zopt = get_optimizer("dct_adamw", lr=0.01, rank=16,
                         zero=ZeroConfig("1"))
    ropt = get_optimizer("dct_adamw", lr=0.01, rank=16)
    zs = zopt.init(params)
    with sharding.set_mesh(None):
        rs = ropt.init(params)
    whole_gathers, orig = [], sharding.gather

    def spy(t, placement, mesh=None):
        whole_gathers.append(t.numel())
        return orig(t, placement, mesh)

    out = {"updates_equal": [], "counts": [], "whole_gathers": []}
    pb = {k: sharding.Block(sharding.local_block(p, specs[k], mesh),
                            specs[k], mesh) if specs[k].splits(mesh) else p
          for k, p in params.items()}
    for t in range(2):
        rng = np.random.default_rng(60 + t)
        g = {k: torch.from_numpy(rng.standard_normal(tuple(p.shape))
                                 .astype(np.float32))
             for k, p in params.items()}
        gb = {k: sharding.Block(sharding.local_block(v, specs[k], mesh),
                                specs[k], mesh) if specs[k].splits(mesh)
              else v for k, v in g.items()}
        mesh.reset_counts()
        whole_gathers.clear()
        sharding.gather = spy
        try:
            u, zs = zopt.update(gb, zs, pb)
        finally:
            sharding.gather = orig
        out["counts"].append({k: list(v) for k, v in mesh.counts.items()})
        out["whole_gathers"].append(list(whole_gathers))
        with sharding.set_mesh(None):
            ur, rs = ropt.update(g, rs, params)
        out["updates_equal"].append(all(
            torch.equal(sharding.held_updates({k: u[k]}, specs, mesh)[k],
                        sharding.local_block(ur[k], specs[k], mesh))
            for k in params))
    zspecs = sharding.optimizer_state_specs(zopt, params,
                                            zero=ZeroConfig("1"), mesh=mesh)
    zw = sharding.gather_tree(zs, zspecs, mesh)
    out["state_equal"] = all(
        pa == pb_ and (torch.equal(a, b) if isinstance(a, torch.Tensor)
                       else a == b)
        for (pa, a), (pb_, b) in zip(tree_items(zw), tree_items(rs)))
    out["leaf_bytes"] = {k: p.numel() * p.element_size()
                         for k, p in params.items()}
    return out


def _megatron_results(mesh, key: str) -> dict:
    """The Megatron cases on one (data, model) mesh."""
    from repro_torch.parallel import sharding

    out = {}
    with sharding.set_mesh(mesh):
        for name in MEG_CASES:
            out[f"meg/{key}/{name}"] = megatron_case(name)
        for layout in MEG_MOE_LAYOUTS:
            out[f"meg/{key}/moe_layout/{layout}"] = moe_layout_case(layout)
        if mesh.shape["data"] > 1:
            out[f"meg/{key}/zero_rows"] = zero_rows()
    return out


# ---------------------------------------------------------------------------
# how a placed run is held to its one-process witness now that the clip's
# norm sums the blocks (test_torch_zero.py, test_torch_fsdp.py)
# ---------------------------------------------------------------------------
#: the clip factor from the blocks' sums of squares against the factor of
#: the same whole gradients' one-process norm, in fp32 ulps
CLIP_ULPS = 4
#: after a clip factor a few ulps off, or Megatron's sums over model:
#: later losses (relative), the parameters in the runs' lr (0.01: Adam's
#: first steps move a weight whose gradient sits near zero by a share of
#: lr whatever its size; measured up to 0.08 lr three steps on from two
#: states 1.8e-4 apart), the Adam moments relative to each leaf's largest
#: entry, the int8 EF in value (of its largest entry)
LATER_LOSS_RTOL = 1e-5
PARAM_LR_SHARE = 0.1
STATE_RTOL = 1e-3
EF_RTOL = 3e-2


def ulps(a, b) -> int:
    """The distance of two positive fp32 values in ulps."""
    ia, ib = (int(torch.tensor(float(v), dtype=torch.float32)
                  .view(torch.int32)) for v in (a, b))
    return abs(ia - ib)


def clip_ulps(norms: torch.Tensor) -> int:
    """The largest distance, in ulps, of a run's clip factors (its steps'
    norms) from the factors of its whole gradients' one-process norms."""
    return max(ulps(clip_scale(n), clip_scale(w))
               for n, w in norms.reshape(-1, 2))


def _close_to(got, want, rtol, what):
    """Within ``rtol`` of the largest entry of ``want``."""
    got, want = got.double(), want.double()
    assert float((got - want).abs().max()) <= rtol * max(
        float(want.abs().max()), 1e-30), what


def assert_clipped_runs(got, want, what, *, megatron: bool = False):
    """A placed run against its one-process witness: the first step's
    gradients before the clip bit for bit and its loss too (at the
    reference's bars where ``megatron``: the loss within 1e-4, the
    gradients at rtol 1e-4 of each leaf's largest entry); every step's
    clip factor within ``CLIP_ULPS`` of its whole gradients'; then the
    later losses, the parameters, the moments, the selections and the EF
    at the bars above."""
    g0, w0 = got["pre_clip"][0], want["pre_clip"][0]
    assert set(g0) == set(w0), what
    if megatron:
        assert abs(float(got["losses"][0] - want["losses"][0])) < 1e-4, \
            (what, got["losses"], want["losses"])
        for k, v in w0.items():
            _close_to(g0[k], v, 1e-4, (what, "pre-clip", k))
    else:
        assert float(got["losses"][0]) == float(want["losses"][0]), \
            (what, got["losses"], want["losses"])
        for k, v in w0.items():
            assert torch.equal(g0[k], v), (what, "pre-clip", k)
        assert float(got["norms"][0, 1]) == float(want["norms"][0, 1]), what
    assert clip_ulps(got["norms"]) <= CLIP_ULPS, (what, got["norms"])
    np.testing.assert_allclose(got["losses"].numpy(), want["losses"].numpy(),
                               rtol=LATER_LOSS_RTOL, err_msg=str(what))
    assert set(got["params"]) == set(want["params"]), what
    for k, v in want["params"].items():
        d = float((got["params"][k].double() - v.double()).abs().max())
        assert d <= PARAM_LR_SHARE * 0.01, (what, k, d)
    gs, ws = got["opt_state"], want["opt_state"]
    assert set(gs) == set(ws), what
    for k, v in ws.items():
        if "||.ef||" in k:
            continue
        if v.is_floating_point():
            _close_to(gs[k], v, STATE_RTOL, (what, k))
        else:                       # selections, steps
            assert torch.equal(gs[k], v), (what, k)
    for k in (k for k in ws if k.endswith("||.ef||.q")):
        leaf = k[:-len("||.ef||.q")]
        deq = [t[k].float() * t[leaf + "||.ef||.scale"] for t in (gs, ws)]
        bar = max(EF_RTOL * float(deq[1].abs().max()),
                  1e-4 * float(ws[leaf + "||.m"].abs().max()))
        assert float((deq[0] - deq[1]).abs().max()) <= bar, (what, k)
