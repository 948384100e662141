"""The slices end to end against the JAX package: the smoke llama's logits,
loss and gradients from the same parameters, 10-step DCT-AdamW loss
trajectories on the same batches, and the training CLI. Trion's
trajectories are in ``test_torch_trion_train.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 - autouse

from repro.configs import llama_paper as jax_llama
from repro.data.synthetic import SyntheticLM
from repro.models import transformer as JT
from repro.optim.api import get_optimizer as jax_get_optimizer
from repro.train import steps as JS
from repro.train.schedule import cosine_warmup as jax_cosine
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as TT
from repro_torch.optim.api import get_optimizer
from repro_torch.train import steps as TS
from repro_torch.train.schedule import cosine_warmup


# the reduced llama-350m: d=128, 4 heads of 32, d_ff 256, one layer, vocab
# 512, fp32 compute, 8-token attention chunks (so 16 tokens take two)
JAX_CFG = jax_llama.SMOKE
CFG = get_config("llama-350m", smoke=True)


def _batch(seed, b=2, s=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, CFG.vocab_size, size=(b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _jax_params():
    return JT.init_params(JAX_CFG, jax.random.PRNGKey(0))


def test_smoke_config_matches_jax():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JAX_CFG)


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("remat", [False, True])
def test_logits_loss_grads_match_jax(remat, layers):
    sched = ((("attn",), layers),)
    jcfg = dataclasses.replace(JAX_CFG, remat=remat, schedule=sched)
    tcfg = dataclasses.replace(CFG, remat=remat, schedule=sched)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    assert set(tparams) == {
        "embed/kernel", "unembed/kernel", "final_norm/scale",
        *(f"segments/0/p0/{k}" for k in (
            "ln1/scale", "ln2/scale", "attn/wq/kernel", "attn/wk/kernel",
            "attn/wv/kernel", "attn/wo/kernel", "mlp/wg/kernel",
            "mlp/wu/kernel", "mlp/wd/kernel"))}
    batch = _batch(0)
    jlogits, _ = jax.jit(JT.forward, static_argnums=2)(
        jparams, {"tokens": jnp.asarray(batch["tokens"])}, jcfg)
    tlogits, _ = TT.forward(tparams, {"tokens": torch.from_numpy(batch["tokens"])},
                            tcfg)
    # rtol 1e-4: fp32 end to end, sums in different orders (matmuls,
    # softmax, norms) through one layer
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    jbatch = jax.tree.map(jnp.asarray, batch)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(JS.loss_fn, has_aux=True),
                                 static_argnums=2)(jparams, jbatch, jcfg)
    tgrads, tmetrics = TS.grad_fn(tparams, {k: torch.from_numpy(v)
                                            for k, v in batch.items()}, tcfg)
    np.testing.assert_allclose(float(tmetrics["loss"]), float(jloss), rtol=1e-5)
    jflat = convert.params_from_jax(jax.tree.map(np.asarray, jgrads),
                                    device="cpu")
    for path, g in tgrads.items():
        want = jflat[path].numpy()
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=path)


# Stated tolerances of the 10-step trajectory (lr 0.01, cosine warmup 2).
# The frameworks sum in different orders, ~1e-7 relative per op. At rank 128
# (= n of the smoke model: every column is kept, no selection) the loss
# stays within 2e-6 of JAX's; rtol 1e-5. At rank 16 the discrete top-r
# selection and the int8 EF rounding amplify those differences, measured up
# to 1.7e-4 by step 6; rtol 1e-3 (the verify skill allows 3e-2 over 30).
TRAJECTORY_CASES = [(128, 1e-5), (16, 1e-3)]


@pytest.mark.parametrize("fused", ["off", "fft"])
@pytest.mark.parametrize("rank,rtol", TRAJECTORY_CASES)
def test_ten_step_loss_trajectory_matches_jax(fused, rank, rtol):
    kw = dict(rank=rank, fused=fused, weight_decay=0.01)
    jopt = jax_get_optimizer("dct_adamw", lr=jax_cosine(0.01, 2, 10), **kw)
    topt = get_optimizer("dct_adamw", lr=cosine_warmup(0.01, 2, 10), **kw)
    jparams = _jax_params()
    jstate = JS.TrainState(jnp.zeros((), jnp.int32), jparams,
                           jopt.init(jparams))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    tstate = TS.TrainState(0, tparams, topt.init(tparams))
    jstep = jax.jit(JS.make_train_step(JAX_CFG, jopt))
    tstep = TS.make_train_step(CFG, topt)
    # learnable batches from the JAX package's synthetic stream, as numpy
    data = SyntheticLM(vocab_size=CFG.vocab_size, seq_len=32, global_batch=4)
    jl, tl = [], []
    for i in range(10):
        b = {k: np.array(v) for k, v in data.batch(jnp.int32(i)).items()}
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    assert tl[-1] < tl[0] - 0.5
    assert tstate.step == 10 and tstate.opt_state.step == 10


def test_train_step_leaves_its_input_state_unchanged():
    opt = get_optimizer("dct_adamw", lr=0.01, rank=16)
    state = TS.init_state(CFG, opt, seed=0, device="cpu")
    before = {k: v.clone() for k, v in state.params.items()}
    new, _ = TS.make_train_step(CFG, opt)(
        state, {k: torch.from_numpy(v) for k, v in _batch(1).items()})
    for k, v in state.params.items():
        assert torch.equal(v, before[k])
        assert not torch.equal(new.params[k], v) or "norm" in k or "ln" in k


def test_cli_runs_on_cpu(capsys):
    assert train_cli.main(["--smoke", "--device", "cpu", "--steps", "3",
                           "--batch", "4", "--seq-len", "32",
                           "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "[trainer] step 3 loss" in out and "[train] done at step 3" in out


def test_cli_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert train_cli.build(["--smoke"]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--smoke", "--steps", "1"])


@pytest.mark.parametrize("argv", [["--zero", "1"], ["--tune-cache", "x"],
                                  ["--optimizer", "adamw", "--fused", "on"],
                                  ["--arch", "whisper-large-v3"]])
def test_cli_unported_choices_fail(argv, capsys):
    """The CLI's choices without a port fail; ``--arch whisper-large-v3``
    was one until the encoder-decoder family was ported, and now trains
    (its batches carry the stub frames); ``--zero 1`` was one until ZeRO-1
    was ported, and in one process now trains replicated and says so."""
    def run(*extra):
        return train_cli.main(["--smoke", "--device", "cpu", "--steps", "1",
                               *extra, *argv])

    if argv[:1] == ["--arch"]:
        assert run("--batch", "2", "--seq-len", "16") == 0
        return
    if argv[:1] == ["--zero"]:
        assert run("--batch", "2", "--seq-len", "16") == 0
        assert "state stays replicated" in capsys.readouterr().out
        return
    with pytest.raises((SystemExit, NotImplementedError)):
        run()


def _spy_cli(monkeypatch):
    """Record the optimizer the CLI builds and the Trion updates it runs."""
    from repro_torch.optim import api
    from repro_torch.optim.trion import TrionRule

    seen = {"built": [], "trion_updates": 0}
    build, update = api.get_optimizer, TrionRule.update

    def get_spy(name, lr, **kw):
        seen["built"].append((name, kw))
        return build(name, lr, **kw)

    def update_spy(self, *a, **kw):
        seen["trion_updates"] += 1
        return update(self, *a, **kw)

    monkeypatch.setattr(api, "get_optimizer", get_spy)
    monkeypatch.setattr(TrionRule, "update", update_spy)
    return seen


def test_cli_default_optimizer_is_trion(monkeypatch, capsys):
    """No --optimizer runs Trion at rank 128, as the JAX CLI does."""
    seen = _spy_cli(monkeypatch)
    argv = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
            "--seq-len", "16", "--log-every", "1"]
    assert train_cli.build(argv).optimizer == "trion"
    assert train_cli.main(argv) == 0
    assert seen["built"] == [("trion", {"weight_decay": 0.01, "rank": 128})]
    # 7 matrix leaves in the smoke llama's one layer, 2 steps
    assert seen["trion_updates"] == 2 * 7
    assert "[train] done at step 2" in capsys.readouterr().out


@pytest.mark.parametrize("argv,want", [
    (["--optimizer", "muon"], ("muon", {"weight_decay": 0.01})),
    (["--optimizer", "muon", "--rank", "16"],
     ("muon", {"weight_decay": 0.01, "rank": 16})),
    (["--optimizer", "dion", "--fused", "on"],
     ("dion", {"weight_decay": 0.01, "rank": 128, "fused": "on"})),
    (["--optimizer", "dct_adamw", "--rank", "32"],
     ("dct_adamw", {"weight_decay": 0.01, "rank": 32})),
])
def test_cli_builds_the_families(monkeypatch, argv, want):
    """Muon is full space without --rank and the rank-r subspace with it;
    --fused reaches the momentum families."""
    seen = _spy_cli(monkeypatch)
    assert train_cli.main(["--smoke", "--device", "cpu", "--steps", "1",
                           "--batch", "2", "--seq-len", "16", *argv]) == 0
    assert seen["built"] == [want]

