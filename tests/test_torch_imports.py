"""The port stands alone: importing ``repro_torch`` and every submodule
loads neither JAX nor any module of the JAX package ``repro``, no port
source, card script or ``chip_smoke.py`` names them in an import, and
``chip_smoke.py`` fails without a CUDA device."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro") or m.startswith(("jax.", "jaxlib.", "repro.")))
print(len(names), bad)
print(" ".join(names))
assert not bad, bad
"""

# the modules of the momentum slice: each must be among those imported
MOMENTUM_MODULES = ("repro_torch.core.newton_schulz",
                    "repro_torch.kernels.newton_schulz",
                    "repro_torch.optim.trion", "repro_torch.optim.muon",
                    "repro_torch.optim.dion")

# the modules of the low-precision / basis slice
LOWP_MODULES = ("repro_torch.kernels.lowp", "repro_torch.kernels.dct_project",
                "repro_torch.kernels.colgather_matmul",
                "repro_torch.core.transforms", "repro_torch.core.fused_step",
                "repro_torch.optim.projected_adam", "repro_torch.convert")

# the modules of the baselines slice
BASELINE_MODULES = ("repro_torch.optim.adamw", "repro_torch.core.projectors",
                    "repro_torch.optim.projected_adam",
                    "repro_torch.optim.transform", "repro_torch.launch.train")

# the modules of the dense-attention / gemma3 slice
ATTENTION_MODULES = ("repro_torch.kernels.flash_attention",
                     "repro_torch.kernels.ops", "repro_torch.models.layers",
                     "repro_torch.configs.gemma3_27b",
                     "repro_torch.configs.registry")


# the modules of the training-substrate slice
SUBSTRATE_MODULES = ("repro_torch.data.pipeline", "repro_torch.train.checkpoint",
                     "repro_torch.train.resilience", "repro_torch.train.chaos",
                     "repro_torch.train.supervisor", "repro_torch.train.loop",
                     "repro_torch.train.steps", "repro_torch.train.schedule")


# the modules of the telemetry slice
TELEMETRY_MODULES = ("repro_torch.telemetry", "repro_torch.telemetry.stats",
                     "repro_torch.telemetry.sink",
                     "repro_torch.telemetry.controllers",
                     "repro_torch.telemetry.adaptive",
                     "repro_torch.core.selection")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    return env


@pytest.fixture(scope="module")
def probe():
    out = subprocess.run([sys.executable, "-c", _PROBE], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.splitlines()


def test_import_every_submodule_without_jax_or_repro(probe):
    n_modules = int(probe[0].split()[0])
    assert n_modules >= 25


@pytest.mark.parametrize("name", MOMENTUM_MODULES)
def test_momentum_modules_import_without_jax_or_repro(probe, name):
    assert name in probe[1].split()


@pytest.mark.parametrize("name", LOWP_MODULES)
def test_lowp_modules_import_without_jax_or_repro(probe, name):
    assert name in probe[1].split()


@pytest.mark.parametrize("name", BASELINE_MODULES)
def test_baseline_modules_import_without_jax_or_repro(probe, name):
    assert name in probe[1].split()


@pytest.mark.parametrize("name", ATTENTION_MODULES)
def test_attention_modules_import_without_jax_or_repro(probe, name):
    assert name in probe[1].split()


@pytest.mark.parametrize("name", SUBSTRATE_MODULES)
def test_substrate_modules_import_without_jax_or_repro(probe, name):
    assert name in probe[1].split()


@pytest.mark.parametrize("name", TELEMETRY_MODULES)
def test_telemetry_modules_import_without_jax_or_repro(probe, name):
    assert name in probe[1].split()


# the modules of the transform-runtime slice
RUNTIME_MODULES = ("repro_torch.devices", "repro_torch.optim.common",
                   "repro_torch.launch.serve", "repro_torch.core.dct",
                   "repro_torch.kernels.ops", "repro_torch.models.transformer")


@pytest.mark.parametrize("name", RUNTIME_MODULES)
def test_runtime_modules_import_without_jax_or_repro(probe, name):
    assert name in probe[1].split()


# the modules of the DeepSeek MoE slice
MOE_MODULES = ("repro_torch.models.moe", "repro_torch.configs.deepseek_moe_16b",
               "repro_torch.configs.deepseek_v3_671b")


@pytest.mark.parametrize("name", MOE_MODULES)
def test_moe_modules_import_without_jax_or_repro(probe, name):
    assert name in probe[1].split()


# the modules of the recurrent-families slice
RECURRENT_MODULES = ("repro_torch.models.mamba", "repro_torch.models.rwkv",
                     "repro_torch.configs.jamba15_large_398b",
                     "repro_torch.configs.rwkv6_1p6b")


@pytest.mark.parametrize("name", RECURRENT_MODULES)
def test_recurrent_modules_import_without_jax_or_repro(probe, name):
    assert name in probe[1].split()


# the modules of the encoder-decoder and cross-attention slice
ENCDEC_MODULES = ("repro_torch.configs.whisper_large_v3",
                  "repro_torch.configs.llama32_vision_90b",
                  "repro_torch.models.transformer",
                  "repro_torch.models.layers",
                  "repro_torch.data.synthetic")


@pytest.mark.parametrize("name", ENCDEC_MODULES)
def test_encdec_modules_import_without_jax_or_repro(probe, name):
    assert name in probe[1].split()


# the modules of the ZeRO-1 slice
ZERO_MODULES = ("repro_torch.parallel", "repro_torch.parallel.sharding",
                "repro_torch.parallel.zero", "repro_torch.launch.mesh",
                "repro_torch.core.selection", "repro_torch.train.loop")


@pytest.mark.parametrize("name", ZERO_MODULES)
def test_zero_modules_import_without_jax_or_repro(probe, name):
    assert name in probe[1].split()


def _reference_all(pkg: str) -> list[str]:
    """``__all__`` of ``repro/<pkg>/__init__.py``, read without importing
    it (this file imports no JAX)."""
    tree = ast.parse((SRC / "repro" / pkg / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    raise AssertionError(f"repro/{pkg} has no __all__")


# names of a reference package's __all__ the port leaves out on purpose:
# ``kernels.ref`` (each kernel module's plain version takes its place) and
# the dry-run cells of ``configs/shapes.py`` (the HLO tooling, queue 1)
NOT_PORTED = {"kernels": {"ref"},
              "configs": {"SHAPES", "input_specs", "cell_applicable",
                          "skip_reason"}}


@pytest.mark.parametrize("pkg", ["core", "kernels", "configs", "optim"])
def test_packages_export_the_reference_names(pkg):
    import importlib
    mod = importlib.import_module(f"repro_torch.{pkg}")
    want = set(_reference_all(pkg)) - NOT_PORTED.get(pkg, set())
    assert want and not want - set(dir(mod)), want - set(dir(mod))
    assert not want - set(mod.__all__), want - set(mod.__all__)


# the public names of the reference's modules this slice ports
RUNTIME_NAMES = {
    "repro_torch.optim.transform": (
        "MaskedNode", "MASKED", "merge_by_label", "clip_global_norm",
        "scale_by_schedule", "matrix_optimizer"),
    "repro_torch.optim.common": ("make_matrix_optimizer", "HarnessState"),
    "repro_torch.core.fused_step": ("set_default_fused_mode",
                                    "default_fused_mode"),
    "repro_torch.core.dct": ("dct_basis_np", "dct2"),
    "repro_torch.kernels.ops": (
        "dct_project_op", "colgather_matmul_op", "colgather_matmul_dual_op",
        "newton_schulz_op", "ns_iteration_op", "flash_attention_op",
        "flash_decode_op", "quantize_ef_op", "dequant_add_ef_op"),
    "repro_torch.kernels.newton_schulz": ("newton_schulz_pallas",),
    "repro_torch.models.transformer": ("ATTN_KINDS", "init_block",
                                       "block_apply", "MLA_KINDS",
                                       "MOE_KINDS", "block_decode"),
    "repro_torch.models.moe": ("MoEParams", "init_moe", "moe_ffn"),
    "repro_torch.models.mamba": ("init_mamba", "mamba_mix",
                                 "init_mamba_cache", "mamba_step"),
    "repro_torch.models.rwkv": ("init_rwkv", "time_mix", "channel_mix",
                                "time_mix_step", "channel_mix_step"),
    "repro_torch.parallel.zero": (
        "ZERO_MODES", "ZeroConfig", "ZERO_OFF", "parse_zero", "ZeroContext",
        "present_axes", "resolve", "eligible", "grad_spec",
        "state_array_spec", "state_specs", "sharded_leaf_update"),
    "repro_torch.parallel.sharding": (
        "DP_AXES", "TP_AXIS", "LAYOUTS", "ShardingPolicy", "current_policy",
        "use_policy", "layout_policy", "active_mesh", "dp_axes", "tp_axis",
        "batch_specs_tree", "opt_state_specs", "set_mesh",
        "get_active_mesh", "seq_parallel", "logical_to_spec", "shard",
        "param_spec", "params_specs", "named_shardings", "cache_specs_tree",
        "telemetry_specs"),
    "repro_torch.launch.mesh": ("make_mesh", "make_production_mesh"),
    "repro_torch.core.selection": ("allsum", "allgather_rows",
                                   "shard_index", "local_row_block"),
}


@pytest.mark.parametrize("module", list(RUNTIME_NAMES))
def test_runtime_names_exist(module):
    import importlib
    mod = importlib.import_module(module)
    missing = [n for n in RUNTIME_NAMES[module] if not hasattr(mod, n)]
    assert not missing, missing


def test_unported_names_say_why():
    """``ON_TPU`` and ``path_str`` are left out, and their modules say so."""
    import importlib
    ops = importlib.import_module("repro_torch.kernels.ops")
    common = importlib.import_module("repro_torch.optim.common")
    assert not hasattr(ops, "ON_TPU") and "``ON_TPU`` is not" in ops.__doc__
    assert not hasattr(common, "path_str") and \
        "``path_str``" in common.__doc__


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


# the port's scripts that run on the card, beside chip_smoke.py (the
# machine with the card has no JAX)
CARD_SCRIPTS = ("attention_kernels_probe.py", "backproject_probe.py",
                "dct_project_probe.py", "ns_apply_tiles_probe.py",
                "runtime_probe.py", "sanitize_kernels.py", "deepseek_probe.py",
                "substrate_probe.py", "telemetry_probe.py",
                "tf32_mma_probe.py", "recurrent_probe.py")


@pytest.mark.parametrize("path", sorted(
    [*(SRC / "repro_torch").rglob("*.py"), ROOT / "chip_smoke.py",
     *(ROOT / "scripts" / name for name in CARD_SCRIPTS)]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_repro(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


def test_chip_smoke_fails_without_cuda(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory with nothing else of the repo, it fails."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
