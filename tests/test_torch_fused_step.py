"""The fused step layer of the port against ``repro.core.fused_step`` in the
same mode, on the same numpy inputs: select + project, the shared-gather
back-projection and the error-feedback add / store, for modes off, fft and
on (the port's "on" runs the kernels' plain versions on CPU tensors, the JAX
package's runs the Pallas kernels in interpret mode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fused_step as jfs
from repro.core.dct import dct2_matrix as jax_dct2
from repro.core.error_feedback import QuantizedBuffer as JQB
from repro.core.transforms import get_backend as jax_backend
from repro_torch.core import fused_step as tfs
from repro_torch.core.dct import dct2_matrix
from repro_torch.core.error_feedback import QuantizedBuffer as TQB
from repro_torch.core.transforms import get_backend as torch_backend

SHAPES = {"2d": (40, 24), "stacked": (3, 40, 24), "odd": (33, 17),
          "transposed": (48, 16)}
MODES = ["off", "fft", "on"]
R = 6


def planted(shape, seed, r=R):
    """G (oriented, n last) whose S = G @ Q has r planted columns 8x larger
    than the rest: the top-r cut has a clear margin, so both frameworks
    must select the same indices."""
    rng = np.random.default_rng(seed)
    *batch, m, n = shape
    s = rng.standard_normal(shape)
    scale = np.full((*batch, n), 0.125)
    for b in np.ndindex(*batch):
        scale[b][rng.permutation(n)[:r]] = 1.0
    q = np.asarray(jax_dct2(n), np.float64)
    return ((s * scale[..., None, :]) @ q.T).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("with_backend", [False, True])
def test_select_and_project_matches_jax(mode, name, with_backend):
    shape = SHAPES[name]
    n = shape[-1]
    g = planted(shape, 1)
    kw_j = {"backend": jax_backend("dct")} if with_backend else {}
    kw_t = {"backend": torch_backend("dct")} if with_backend else {}
    ji, jg, jn = jfs.select_and_project(jnp.asarray(g), jax_dct2(n), R,
                                        mode=mode, return_norms=True, **kw_j)
    ti, tg, tn = tfs.select_and_project(_t(g), dct2_matrix(n), R, mode=mode,
                                        return_norms=True, **kw_t)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # rtol 1e-5: S from a matmul or an FFT, fp32 sums in different orders
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5)
    ti2, tg2 = tfs.select_and_project(_t(g), dct2_matrix(n), R, mode=mode,
                                      **kw_t)
    np.testing.assert_array_equal(ti2.numpy(), ti.numpy())


@pytest.mark.parametrize("name", list(SHAPES))
def test_project_with_indices_matches_jax(name):
    *batch, m, n = SHAPES[name]
    g = planted(SHAPES[name], 2)
    idx = np.sort(np.random.default_rng(3).permutation(n)[:R]).astype(np.int32)
    idx = np.broadcast_to(idx, (*batch, R)).copy()
    want = jfs.project_with_indices(jnp.asarray(g), jax_dct2(n), jnp.asarray(idx))
    got = tfs.project_with_indices(_t(g), dct2_matrix(n), _t(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(SHAPES))
def test_fused_dual_backproject_matches_jax(mode, name):
    *batch, m, n = SHAPES[name]
    rng = np.random.default_rng(4)
    u = rng.standard_normal((*batch, m, R)).astype(np.float32)
    gl = rng.standard_normal((*batch, m, R)).astype(np.float32)
    idx = np.stack([np.sort(rng.permutation(n)[:R])
                    for _ in range(int(np.prod(batch, dtype=int)))]
                   ).reshape(*batch, R).astype(np.int32)
    jd, jr = jfs.fused_dual_backproject(jnp.asarray(u), jnp.asarray(gl),
                                        jax_dct2(n), jnp.asarray(idx), mode=mode)
    q = dct2_matrix(n)
    for qt in (None, q.T.contiguous()):
        td, tr = tfs.fused_dual_backproject(_t(u), _t(gl), q, _t(idx),
                                            mode=mode, qt=qt)
        # rtol 1e-5: r-term fp32 sums in different orders
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(SHAPES))
def test_ef_add_and_store_match_jax(mode, name):
    shape = SHAPES[name]
    rng = np.random.default_rng(5)
    g = rng.standard_normal(shape).astype(np.float32)
    resid = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    jb = jfs.ef_store(jnp.asarray(resid), "q8", mode=mode)
    tb = tfs.ef_store(_t(resid), "q8", mode=mode)
    assert isinstance(tb, TQB)
    # scales: the IEEE quotient in the port, within one ulp in the JAX
    # package (its interpret-mode kernel multiplies by 1/127); payload
    # within one unit
    np.testing.assert_array_max_ulp(tb.scale.numpy(), np.asarray(jb.scale), 1)
    assert np.abs(tb.q.numpy().astype(int)
                  - np.asarray(jb.q).astype(int)).max() <= 1
    # the add on the port's own buffer, handed to both
    jbuf = JQB(q=jnp.asarray(tb.q.numpy()), scale=jnp.asarray(tb.scale.numpy()))
    out_t = tfs.ef_add(_t(g), tb, mode=mode)
    out_j = jfs.ef_add(jnp.asarray(g), jbuf, mode=mode)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-6,
                               atol=1e-7)
    # fp32 buffers pass straight through both
    np.testing.assert_array_equal(
        tfs.ef_store(_t(resid), "fp32", mode=mode).numpy(), resid)
    np.testing.assert_allclose(
        tfs.ef_add(_t(g), _t(resid), mode=mode).numpy(),
        np.asarray(jfs.ef_add(jnp.asarray(g), jnp.asarray(resid), mode=mode)))


def test_ef_add_makes_a_new_tensor():
    """G + EF must not write into the gradient (``.float()`` of an fp32
    tensor is the tensor itself)."""
    g = torch.ones(4, 8)
    buf = tfs.ef_store(torch.full((4, 8), 0.5), "q8", mode="on")
    for mode in MODES:
        out = tfs.ef_add(g.float(), buf, mode=mode)
        assert out.data_ptr() != g.data_ptr()
        assert torch.equal(g, torch.ones(4, 8))


def test_resolve_by_device():
    assert tfs.resolve("auto", "cpu") == "off"
    assert tfs.resolve("auto", torch.device("cuda")) == "on"
    for mode in ("on", "fft", "off"):
        assert tfs.resolve(mode, "cpu") == mode
    with pytest.raises(ValueError):
        tfs.resolve("bogus", "cpu")


@pytest.fixture
def default_mode_restored():
    """Puts the process-wide default back whatever the test did."""
    yield
    tfs.set_default_fused_mode("auto")


def _rule_updates(fused, shape=(3, 40, 24)):
    """Two DCT-AdamW leaf updates of a rule with ``fused``, and its state."""
    from repro_torch.optim.common import Context
    from repro_torch.optim.projected_adam import ProjectedAdamRule

    n = shape[-1]
    bases = {str(n): dct2_matrix(n)}
    rule = ProjectedAdamRule(rank=R, fused=fused)
    state = rule.init(shape, torch.float32, "cpu")
    out = []
    for step, seed in enumerate((1, 2), 1):
        ctx = Context(step=step, bases=bases,
                      bases_t={k: q.T.contiguous() for k, q in bases.items()})
        d, state = rule.update(_t(planted(shape, seed)), state, None, ctx)
        out.append(d)
    return out, state


def test_default_fused_mode_routes_auto_rules(default_mode_restored):
    """``set_default_fused_mode("fft")``: a rule with ``fused="auto"`` gives
    ``fused="fft"``'s updates and state bit for bit, on any device; "auto"
    puts the device rule back."""
    assert tfs.default_fused_mode() == "auto"
    tfs.set_default_fused_mode("fft")
    assert tfs.default_fused_mode() == "fft"
    assert tfs.resolve("auto", "cpu") == tfs.resolve("auto", "cuda") == "fft"
    assert tfs.resolve("off", "cpu") == "off"
    (auto, sa), (fft, sf) = _rule_updates("auto"), _rule_updates("fft")
    for a, f in zip(auto, fft):
        assert torch.equal(a, f)
    assert torch.equal(sa.proj, sf.proj) and torch.equal(sa.m, sf.m)
    assert torch.equal(sa.ef.q, sf.ef.q)
    tfs.set_default_fused_mode("auto")
    assert tfs.resolve("auto", "cpu") == "off"
    (auto, _), (off, _) = _rule_updates("auto"), _rule_updates("off")
    assert all(torch.equal(a, o) for a, o in zip(auto, off))
    with pytest.raises(ValueError, match="unknown fused mode"):
        tfs.set_default_fused_mode("bogus")
    assert tfs.default_fused_mode() == "auto"
