"""The port's entry points run on the card unless the caller asks for the
CPU: each one, called without a device, raises where there is no CUDA
device (this machine), and with ``device="cpu"`` gives CPU tensors.
``resolve_device`` is the one place that decides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.api import get_optimizer as jax_get_optimizer
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.data.synthetic import SyntheticLM, make_batch_fn
from repro_torch.devices import NO_CARD, resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim.api import get_optimizer
from repro_torch.serve.kv_cache import PagedCacheConfig, PagedKVCache
from repro_torch.train import steps as S

CFG = get_config("llama-350m", smoke=True)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def _jax_state():
    """A JAX DCT-AdamW ChainState of a small tree, leaves as numpy."""
    params = {"w": {"kernel": jnp.ones((16, 24))}, "norm": jnp.ones((24,))}
    opt = jax_get_optimizer("dct_adamw", lr=0.01, rank=4, fused="off")
    return jax.tree.map(np.asarray, opt.init(params))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


CACHE_CFG = PagedCacheConfig(block_size=4, num_blocks=8, max_blocks_per_seq=4)
TREE = {"a": {"kernel": np.ones((3, 4), np.float32)}, "b": [np.zeros(2)]}
POOLS = [{"p0": {"k": np.zeros((1, 2, 4, 2, 8), np.float32),
                 "v": np.zeros((1, 2, 4, 2, 8), np.float32)}}]

# entry point -> a call with the device keyword given (or not)
ENTRY_POINTS = {
    "init_params": lambda **d: T.init_params(CFG, 0, **d),
    "init_state": lambda **d: S.init_state(
        CFG, get_optimizer("dct_adamw", lr=0.01, rank=8), 0, **d),
    "init_cache": lambda **d: T.init_cache(CFG, 2, 16, **d),
    "init_paged_pools": lambda **d: T.init_paged_pools(CFG, 8, 4, **d),
    "init_prefill_scratch": lambda **d: T.init_prefill_scratch(CFG, 16, **d),
    "PagedKVCache": lambda **d: PagedKVCache(CFG, CACHE_CFG, 2, **d).pools,
    "SyntheticLM.batch": lambda **d: SyntheticLM(
        vocab_size=CFG.vocab_size, seq_len=8, global_batch=2).batch(0, **d),
    "make_batch_fn": lambda **d: make_batch_fn(CFG, 8, 2, **d)(0),
    "params_from_jax": lambda **d: convert.params_from_jax(TREE, **d),
    "pools_from_jax": lambda **d: convert.pools_from_jax(POOLS, **d),
    "opt_state_from_jax": lambda **d: convert.opt_state_from_jax(
        _jax_state(), **d),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_without_device_raises_without_card(no_card, name):
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_on_cpu_gives_cpu_tensors(name):
    out = ENTRY_POINTS[name](device="cpu")
    tensors = list(_tensors(out))
    assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_resolve_device(no_card):
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    assert resolve_device("meta") == torch.device("meta")
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError) as err:
            resolve_device(dev)
        assert str(err.value) == NO_CARD
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("xpu")


def test_meta_gives_shapes_only():
    p = T.init_params(CFG, 0, device="meta")
    assert all(t.device.type == "meta" for t in p.values())
    assert T.param_count(p) == T.param_count(T.init_params(CFG, 0, "cpu"))
