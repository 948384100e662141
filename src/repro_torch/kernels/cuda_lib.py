"""Build, load and call the hand-written CUDA kernels of ``repro_torch/csrc``.

Every ``*.cu`` file under ``csrc/`` is compiled with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded with
``ctypes``. The build runs at first use, into ``build/repro_torch_kernels/``
at the root of the checkout, under a name keyed by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once. The
sources compile in parallel, one ``nvcc`` each.

No ``--use_fast_math``: the quantizer's IEEE division and its handling of
subnormal rows depend on it being off, and flash decode's ``expf`` stays
the accurate one.

Nothing here runs at import time: the CPU tests import this module and
never build or launch a kernel.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry point -> argument types; every pointer and the stream are c_void_p
SIGNATURES = {
    "repro_quantize_ef": (_P, _P, _P, _L, _I, _P),
    "repro_dequant_add_ef": (_P, _P, _P, _P, _L, _I, _P),
    "repro_dct_project": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "repro_dct_project_block_rows": (),
    "repro_colgather_matmul_dual": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "repro_flash_decode": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _I, _I, _I, _F, _I, _I, _P),
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda; "
                           "the CUDA kernels cannot be built")
    return path


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _build(sources: list[Path], out: Path) -> str:
    """Compile each source to an object in parallel, link them into ``out``
    (atomically renamed into place). Returns the compiler's log."""
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / f"{s.stem}.o" for s in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for s, o in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        for s, p, log in zip(sources, procs, logs):
            if p.returncode:
                raise RuntimeError(f"nvcc failed on {s.name}:\n{log}")
        so = Path(tmp) / out.name
        link = subprocess.run([nvcc, *GENCODE, "-shared", "-o", str(so),
                               *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(so, out)
    log = "".join(logs)
    out.with_suffix(".log").write_text(log)
    return log


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash is new."""
    sources = sorted(CSRC.glob("*.cu"))
    out = BUILD_DIR / f"librepro_torch_kernels-{_digest(sources)}.so"
    if not out.exists():
        _build(sources, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def build_log() -> str:
    """ptxas' register / shared-memory report of the loaded build."""
    sources = sorted(CSRC.glob("*.cu"))
    log = BUILD_DIR / f"librepro_torch_kernels-{_digest(sources)}.log"
    return log.read_text() if log.exists() else ""


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc:
        msg = library().repro_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple[int, ...] | None = None) -> None:
    """The checks every wrapper makes before it passes ``data_ptr()`` on: a
    transposed view, a wrong dtype or a CPU tensor would silently compute
    on the wrong data."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor "
                         f"(call .contiguous() on transposed views)")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def same_device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts[1:]):
        raise ValueError(f"tensors on different devices: "
                         f"{[str(t.device) for t in ts]}")
    return dev
