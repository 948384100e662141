"""The port's placements (``repro_torch.parallel.sharding``) against the JAX
package's PartitionSpecs (``repro.parallel.sharding``), as tuples.

Spec derivation reads only axis names and sizes, so a mesh stand-in does
(``FakeMesh``, as ``tests/test_sharding_specs.py``). Every architecture of
both registries at full width: the reference's parameter tree from
``jax.eval_shape`` of its ``init_params``, the port's from ``init_params``
on ``meta`` (nothing is allocated), under the three layouts on five meshes.
Then ``logical_to_spec`` / ``seq_parallel`` / ``shard``, the optimizer
state's placements leaf by leaf (the cases of ``test_sharding_specs.py``:
both runtimes, the layouts, ZeRO-1, ineligible rows, inject-hyperparams),
every family's decode cache at a batch that divides the data axes and at
B = 1, the telemetry trees, and the blocks a multi-axis placement cuts.
"""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import registry as jreg
from repro.models import transformer as JT
from repro.optim.common import path_str
from repro.parallel import sharding as jsh
from repro.parallel import zero as jzero
from repro_torch.configs import registry as preg
from repro_torch.models import transformer as PT
from repro_torch.parallel import sharding as sh
from repro_torch.parallel import zero


@dataclasses.dataclass(frozen=True)
class FakeMesh:
    """Axis names and sizes: all that placement derivation reads."""

    sizes: tuple

    @property
    def axis_names(self):
        return tuple(n for n, _ in self.sizes)

    @property
    def shape(self):
        return dict(self.sizes)


MESHES = {
    "pod2-data4-model2": FakeMesh((("pod", 2), ("data", 4), ("model", 2))),
    "data16-model16": FakeMesh((("data", 16), ("model", 16))),
    "pod2-data16-model16": FakeMesh((("pod", 2), ("data", 16),
                                     ("model", 16))),
    "data2-model1": FakeMesh((("data", 2), ("model", 1))),
    "data1-model2": FakeMesh((("data", 1), ("model", 2))),
}
ARCHS = jreg.list_archs()


def test_registries_agree():
    assert preg.list_archs() == ARCHS


@functools.lru_cache(maxsize=None)
def _trees(arch: str):
    """The reference's ``{path: ShapeDtypeStruct}`` and the port's meta
    parameters of ``arch`` at full width."""
    tree = jax.eval_shape(lambda: JT.init_params(jreg.get_config(arch),
                                                 jax.random.PRNGKey(0)))
    flat = {path_str(kp): x for kp, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    return tree, flat, PT.init_params(preg.get_config(arch), 0, "meta")


def _ref_tuples(tree) -> dict:
    return {path_str(kp): tuple(s) for kp, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))[0]}


@pytest.mark.parametrize("layout", sh.LAYOUTS)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh, layout):
    """``params_specs`` of the port's tree and ``param_spec`` of each of
    the reference's leaves give the reference's spec tuples."""
    m = MESHES[mesh]
    tree, flat, params = _trees(arch)
    with jsh.use_policy(layout=layout):
        want = _ref_tuples(jsh.params_specs(tree, m))
    with sh.use_policy(layout=layout):
        got = {k: p.entries for k, p in sh.params_specs(params, m).items()}
        one = {k: sh.param_spec(k, tuple(x.shape), m).entries
               for k, x in flat.items()}
    assert got == want
    assert one == want
    assert {k: tuple(p.shape) for k, p in params.items()} == \
        {k: tuple(x.shape) for k, x in flat.items()}


@pytest.mark.parametrize("layout", sh.LAYOUTS)
def test_param_specs_split_the_matrices(layout):
    """llama-350m on (data 16, model 16): what each layout splits."""
    _, _, params = _trees("llama-350m")
    m = MESHES["data16-model16"]
    with sh.use_policy(layout=layout):
        specs = sh.params_specs(params, m)
    split = {k for k, p in specs.items() if p.split}
    if layout == "pure_dp":
        assert split == set()
    else:
        assert split == {k for k, p in params.items() if p.dim() >= 2
                         and "norm" not in k and "ln" not in k}
    assert sh.current_policy().layout == "fsdp_tp"


LOGICAL = [("batch", None, "tp"), ("seq", "sp"), ("batch", "seq", "sp"),
           (None, "tp"), ("sp",), ()]


@pytest.mark.parametrize("seq_parallel", [False, True])
@pytest.mark.parametrize("layout", sh.LAYOUTS)
@pytest.mark.parametrize("mesh", [None, *MESHES])
def test_logical_to_spec(mesh, layout, seq_parallel):
    m = MESHES.get(mesh)
    for axes in LOGICAL:
        with jsh.use_policy(layout=layout, seq_parallel=seq_parallel):
            want = tuple(jsh.logical_to_spec(axes, m))
            assert jsh.seq_parallel() is seq_parallel
        with sh.use_policy(layout=layout, seq_parallel=seq_parallel):
            assert sh.logical_to_spec(axes, m).entries == want, axes
            assert sh.seq_parallel() is seq_parallel
    assert sh.seq_parallel() is False


def test_logical_names_and_shard():
    """An unknown name raises the reference's ValueError; ``shard``
    checks its names and returns its input, with or without a mesh."""
    with pytest.raises(ValueError) as e:
        sh.logical_to_spec(("batch", "heads"))
    with pytest.raises(ValueError) as je:
        jsh.logical_to_spec(("batch", "heads"))
    assert str(e.value) == str(je.value)
    x = torch.ones(4, 8)
    assert sh.shard(x, "batch", "tp") is x
    with sh.set_mesh(MESHES["data16-model16"]):
        assert sh.shard(x, "batch", None) is x
        with pytest.raises(ValueError):
            sh.shard(x, "vocab")


# ---------------------------------------------------------------------------
# the optimizer state (the cases of tests/test_sharding_specs.py)
# ---------------------------------------------------------------------------
OPT_MESH = MESHES["pod2-data4-model2"]
SHAPES = {"blocks/wq": (3, 64, 48), "blocks/wo": (48, 64),
          "embed": (100, 64), "norm": (64,)}


def _nested(flat: dict) -> dict:
    out = {}
    for k, v in flat.items():
        node = out
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _fields(tree, prefix="") -> dict:
    """``{field path: spec tuple}`` of a per-leaf spec tree of either
    package."""
    if isinstance(tree, P):
        return {prefix: tuple(tree)}
    if isinstance(tree, sh.Placement):
        return {prefix: tree.entries}
    out = {}
    if hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            out.update(_fields(v, f"{prefix}.{f}"))
    return out


def _leaf_specs(o_specs, runtime, port: bool) -> dict:
    """``{param path: {field: spec}}`` of every parameter's state."""
    leaves = o_specs.leaves
    if runtime == "legacy":
        groups = [leaves]
    elif runtime == "inject":
        groups = [leaves.inner[0]]
    else:
        groups = [leaves[0]["lowrank"], leaves[0]["full"]]
    out = {}
    for g in groups:
        flat = g if port else {
            path_str(kp): v for kp, v in jax.tree_util.tree_flatten_with_path(
                g, is_leaf=lambda x: hasattr(x, "_fields"))[0]}
        out.update({k: _fields(v) for k, v in flat.items()})
    return out


def _build(mod, runtime: str, rule_mod):
    rule = rule_mod.ProjectedAdamRule(rank=8, residual="ef", ef_dtype="q8")
    if runtime == "legacy":
        return importlib.import_module(f"{mod}.optim.common") \
            .make_matrix_optimizer(rule, 0.01)
    t = importlib.import_module(f"{mod}.optim.transform")
    if runtime == "inject":
        return t.as_optimizer(t.inject_hyperparams(
            rule_mod.dct_adamw_transform)(lr=0.01, rank=8))
    return t.matrix_optimizer(rule, 0.01)


def _opt_specs(runtime, layout, zero_on, shapes):
    """Both packages' optimizer-state placements of ``shapes``."""
    pa = {m: importlib.import_module(f"{m}.optim.projected_adam")
          for m in ("repro", "repro_torch")}
    if runtime == "inject":
        shapes = {k: s for k, s in shapes.items() if k.startswith("blocks")}
    jparams = _nested({k: jnp.zeros(s, jnp.float32)
                       for k, s in shapes.items()})
    jstate = jax.eval_shape(_build("repro", runtime, pa["repro"]).init,
                            jparams)
    params = {k: torch.zeros(s) for k, s in shapes.items()}
    state = _build("repro_torch", runtime, pa["repro_torch"]).init(params)
    with jsh.use_policy(layout=layout):
        jspecs = jsh.opt_state_specs(
            jstate, jparams, jsh.params_specs(jparams, OPT_MESH),
            zero=jzero.ZeroConfig("1") if zero_on else None, mesh=OPT_MESH)
    with sh.use_policy(layout=layout):
        specs = sh.opt_state_specs(
            state, params, sh.params_specs(params, OPT_MESH),
            zero=zero.ZeroConfig("1") if zero_on else None, mesh=OPT_MESH)
    return jspecs, specs


@pytest.mark.parametrize("zero_on", [False, True], ids=["zero-off", "zero-1"])
@pytest.mark.parametrize("layout", sh.LAYOUTS)
@pytest.mark.parametrize("runtime", ["legacy", "chain", "inject"])
def test_opt_state_specs_match_reference(runtime, layout, zero_on):
    """Every array of every parameter's state: the moments' row entries
    kept and the rank dim whole, the q8 EF payload following the
    (transposed) parameter, its per-row scales the row entries, indices
    and steps replicated, the full-rank moments as the parameter; under
    ZeRO-1 the eligible leaves by rows over the data axes."""
    jspecs, specs = _opt_specs(runtime, layout, zero_on, SHAPES)
    want = _leaf_specs(jspecs, runtime, port=False)
    got = _leaf_specs(specs, runtime, port=True)
    assert got == want
    assert want["blocks/wq"][".m"]          # the walk reached the leaves


def test_opt_state_specs_zero_ineligible_rows():
    """Rows not divisible by the shard count keep the shape-matched
    placement."""
    jspecs, specs = _opt_specs("chain", "fsdp_tp", True,
                               {"blocks/wq": (36, 20)})
    want = _leaf_specs(jspecs, "chain", port=False)
    assert _leaf_specs(specs, "chain", port=True) == want
    # 36 % 8: not ZeRO's rows; the parameter's d_in does not split 8 ways
    # either, so the moments' rows replicate
    assert want["blocks/wq"][".m"] == (None, None)
    assert want["blocks/wq"][".ef.q"] == (None, "model")


def test_optimizer_state_specs_of_meta_state():
    """``optimizer_state_specs`` (the state of the shapes on ``meta``,
    built outside any mesh) equals ``opt_state_specs`` of the whole
    state."""
    from repro_torch.optim.api import get_optimizer

    params = {k: torch.zeros(s) for k, s in SHAPES.items()}
    opt = get_optimizer("dct_adamw", lr=0.01, rank=8)
    with sh.set_mesh(OPT_MESH):
        got = sh.optimizer_state_specs(opt, params,
                                       zero=zero.ZeroConfig("1"))
    want = sh.opt_state_specs(opt.init(params), params,
                              sh.params_specs(params, OPT_MESH),
                              zero=zero.ZeroConfig("1"), mesh=OPT_MESH)
    assert sh.placements_by_path(got) == sh.placements_by_path(want)


# ---------------------------------------------------------------------------
# decode caches and telemetry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("batch", [32, 1])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_tree(arch, mesh, batch):
    """Every family's cache (KV, MLA latent, conv / ssm / wkv states,
    cross caches) at a batch that divides the data axes and at B = 1,
    where an attention cache's sequence goes on the data axes."""
    m, max_len = MESHES[mesh], 64
    jcache = jax.eval_shape(lambda: JT.init_cache(jreg.get_config(arch),
                                                  batch, max_len))
    want = {f"segments/{k}": v for k, v in _ref_tuples(
        jsh.cache_specs_tree(jcache, m)).items()}
    cache = PT.init_cache(preg.get_config(arch), batch, max_len, "meta")
    got = {k: p.entries for k, p in sh.cache_specs_tree(cache, m).items()}
    assert got == want


def test_telemetry_specs():
    """Every leaf of a telemetry tree replicates, in both packages."""
    from repro.telemetry.stats import SubspaceStats as JStats
    from repro_torch.telemetry.stats import SubspaceStats

    z = np.zeros((3,), np.float32)
    jtree = {"blocks/wq": JStats(*[jnp.asarray(z)] * 5),
             "ctl": {"rank": jnp.int32(4)}}
    tree = {"blocks/wq": SubspaceStats(*[torch.from_numpy(z)] * 5),
            "ctl": {"rank": 4}}
    want = _ref_tuples(jsh.telemetry_specs(jtree))
    got = {"/".join(p): s.entries for p, s in
           sh.placements_by_path(sh.telemetry_specs(tree)).items()}
    assert got == want and set(want.values()) == {()} and len(want) == 6


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
class _Rank:
    """One rank of a mesh, for cutting blocks in one process."""

    def __init__(self, sizes, rank):
        from repro_torch.launch.mesh import Mesh

        self.axis_names = tuple(n for n, _ in sizes)
        self.shape = dict(sizes)
        self.rank = rank
        self.coords = functools.partial(Mesh.coords, self)
        self.shard_index = functools.partial(Mesh.shard_index, self)


@pytest.mark.parametrize("entries", [
    (("data",), "model"), ("model", ("pod", "data")),
    (None, ("pod", "data", "model")), (("data", "model"), None)],
    ids=["dp-tp", "tp-podxdp", "all", "dpxtp"])
def test_local_blocks_tile_the_array(entries):
    """Each rank's block of a multi-axis placement, put back in the
    reference's order (row-major over each entry's axes), is the whole
    array; ``state_bytes`` counts held and whole."""
    sizes = (("pod", 2), ("data", 2), ("model", 2))
    x = torch.arange(16 * 24, dtype=torch.float32).reshape(16, 24)
    pl = sh.Placement(entries)
    ranks = [_Rank(sizes, r) for r in range(8)]
    blocks = {r.rank: sh.local_block(x, pl, r) for r in ranks}
    ns = [n for _, _, n in pl.splits(ranks[0])]
    assert blocks[0].shape == sh.block_shape(x.shape, pl, ranks[0])
    rebuilt = torch.empty_like(x)
    for r in ranks:
        idx = [slice(None)] * 2
        for d, axes, n in pl.splits(r):
            size = x.shape[d] // n
            i = r.shard_index(axes)
            idx[d] = slice(i * size, (i + 1) * size)
        rebuilt[tuple(idx)] = blocks[r.rank]
    assert torch.equal(rebuilt, x)
    named = sh.named_shardings({"x": pl, "y": [sh.REPLICATED]}, ranks[3])
    assert named["x"].spec == pl and named["y"][0].spec == sh.REPLICATED
    assert torch.equal(named["x"].local_block(x), blocks[3])
    held, whole = sh.state_bytes({"x": blocks[0]}, {"x": pl}, ranks[0])
    assert held * int(np.prod(ns)) == whole == x.numel() * 4
    with pytest.raises(ValueError, match="does not split"):
        sh.local_block(x[:15], sh.Placement((("pod", "data", "model"),)),
                       ranks[0])


def test_zero_row_placements_are_one_split_dim():
    """ZeRO-1's row placements are the one-split-dim case, with the
    reference's spec tuples."""
    for shape in ((3, 64, 48), (33, 80)):
        got = zero.grad_spec(shape, ("pod", "data"))
        assert got.entries == tuple(jzero.grad_spec(shape, ("pod", "data")))
        assert got.spec(len(shape)) == got.entries
    assert zero.state_array_spec((33, 80), (80, 8), ("data",)).entries == \
        tuple(jzero.state_array_spec((33, 80), (80, 8), ("data",)))
