"""Fault-tolerant checkpointing: atomic, verified, keep-k, async — the
on-disk format of ``repro/train/checkpoint.py``, so either package verifies
and restores the other's checkpoints of the same leaves.

Format: one directory ``step_N/`` per step holding ``state.npz`` (a flat
``.npz`` of every leaf, keyed by its path), ``manifest.json`` (``format:
2``, a per-leaf ``crc32`` / ``shape`` / ``dtype`` record under ``leaves``,
and the caller's extra keys) and an ``OK`` marker. Writes go to
``step_N.tmp`` and are published by ``os.rename``, so a crash mid-write
never corrupts the latest checkpoint. ``restore`` re-checksums what it
loaded and raises :class:`CheckpointCorruptError` on any mismatch;
``restore_latest`` / ``latest_verified_step`` walk back past corrupt
checkpoints and quarantine them as ``step_N.corrupt``. The publish (rename
+ keep-k GC) and every directory scan happen under one lock; a pending
writer is drained before a new save starts; orphaned ``step_*.tmp``
directories are swept at startup.

Leaf paths: a dict key, a list or tuple index, and ``.field`` for a
NamedTuple field (JAX's ``GetAttrKey`` spelling), joined by ``||``; None
holds no leaf. Tensors are saved as numpy arrays in their dtype (bf16 as
its uint16 bits, with manifest dtype ``"bfloat16"``, so that the CRC covers
the bytes JAX's ``ml_dtypes`` array holds); Python ints (``TrainState.step``,
``ChainState.step`` / ``seed``, ``ProjAdamLeaf.inner_step``) as 0-d int64
arrays, restored as ints. ``restore`` rebuilds the structure of its target
(``init_state_fn()``'s state) on the target's device and in its dtypes.

``async_save`` copies device -> host on the caller's thread, before the next
step can start (span ``ckpt/snapshot``, histogram ``ckpt_snapshot_seconds``:
the port's own, beside the reference's instruments); only the disk IO goes
to the writer thread.

Checkpoints are saved whole ("unsharded-logical", as the reference's):
under data parallelism the Trainer all-gathers the ZeRO-1 row blocks
(``parallel.sharding.gather_tree``) and rank 0 writes. ``restore(step,
target, shardings)`` cuts this rank's block of each split leaf out of the
whole array on the host (``sharding.local_block``) before it moves to the
device, so a run saved at one data-parallel width resumes at another.

``fault_hook(stage, step)`` is the chaos seam (train/chaos.py), called at
``"pre_write"`` / ``"mid_write"`` (after state.npz, before OK) /
``"pre_publish"`` / ``"published"``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import zlib
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import obs

_SEP = "||"
_BF16 = "bfloat16"


def _ckpt_metrics():
    """Checkpoint-IO instruments under the reference's names (no-ops until
    ``obs.enable()``)."""
    r = obs.registry()
    return {
        "save_s": r.histogram("ckpt_save_seconds",
                              "write + publish of one checkpoint "
                              "(writer-thread time for async)"),
        "restore_s": r.histogram("ckpt_restore_seconds",
                                 "load + verify + rebuild of one "
                                 "checkpoint"),
        "verify_s": r.histogram("ckpt_verify_seconds",
                                "standalone load + CRC verification"),
        # the port's own: the caller-thread device -> host copy of a save
        "snapshot_s": r.histogram("ckpt_snapshot_seconds",
                                  "device -> host copy of the state on the "
                                  "caller's thread (async_save)"),
        "bytes_written": r.counter("ckpt_bytes_written_total",
                                   "uncompressed leaf bytes saved"),
        "bytes_read": r.counter("ckpt_bytes_read_total",
                                "uncompressed leaf bytes loaded on "
                                "restore"),
        "saves": r.counter("ckpt_saves_total", "published checkpoints"),
        "restores": r.counter("ckpt_restores_total",
                              "successful restores"),
        "corrupt": r.counter("ckpt_corruptions_total",
                             "verification failures"),
    }


def _nbytes(flat: dict[str, np.ndarray]) -> int:
    return sum(a.nbytes for a in flat.values())


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification (CRC/shape/dtype/read)."""


def tree_map_with_path(fn, tree, prefix: tuple = ()):
    """``tree`` with every leaf (a tensor or a Python int) replaced by
    ``fn(path, leaf)``. ``path`` is a tuple of dict keys, list or tuple
    indices and ``".field"`` for NamedTuple fields (JAX's ``GetAttrKey``
    spelling); None holds no leaf. The one walker of the port's state
    trees: the checkpoint format, ``resilience.all_finite_tree`` and
    ``scale_hyperparam`` go through it."""
    if isinstance(tree, (torch.Tensor, int)):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, prefix + (f".{k}",))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    if tree is not None:
        raise TypeError(f"a state tree holds no {type(tree).__name__} "
                        f"(at {_SEP.join(prefix)!r})")
    return None


def tree_items(tree) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` for every tensor and int of ``tree``, in order."""
    out = []
    tree_map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of one leaf (bf16 as its uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf, dtype=np.int64)


def _flatten(tree) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """The leaves as host arrays, and the manifest dtype of the bf16 ones."""
    flat, dtypes = {}, {}
    for path, leaf in tree_items(tree):
        key = _SEP.join(path)
        flat[key] = _to_numpy(leaf)
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            dtypes[key] = _BF16
    return flat, dtypes


def _crc(arr: np.ndarray) -> int:
    # the bytes in C order, whatever the strides (tobytes()'s), read
    # through the array's buffer instead of a copy
    return zlib.crc32(np.ascontiguousarray(arr)) & 0xFFFFFFFF


def _integrity(flat: dict[str, np.ndarray],
               dtypes: dict[str, str]) -> dict[str, dict]:
    """Per-leaf CRC32 + shape/dtype — the manifest's verification record."""
    return {key: {"crc32": _crc(arr), "shape": list(arr.shape),
                  "dtype": dtypes.get(key, str(arr.dtype))}
            for key, arr in flat.items()}


def _check_integrity(step: int, flat: dict[str, np.ndarray],
                     leaves: dict[str, dict]) -> None:
    """Raise CheckpointCorruptError on any CRC/shape/dtype mismatch."""
    missing = sorted(set(leaves) - set(flat))
    if missing:
        raise CheckpointCorruptError(
            f"step {step}: state.npz is missing leaves {missing[:4]}"
            + ("..." if len(missing) > 4 else ""))
    for key, rec in leaves.items():
        arr = flat[key]
        dtype = str(arr.dtype)
        if rec["dtype"] == _BF16 and arr.dtype.itemsize == 2 \
                and arr.dtype.kind in "uV":
            dtype = _BF16               # bf16 bits (uint16, or JAX's V2)
        if list(arr.shape) != list(rec["shape"]) or dtype != rec["dtype"]:
            raise CheckpointCorruptError(
                f"step {step}: leaf {key!r} is "
                f"{arr.dtype}{list(arr.shape)}, manifest says "
                f"{rec['dtype']}{rec['shape']}")
        crc = _crc(arr)
        if crc != rec["crc32"]:
            raise CheckpointCorruptError(
                f"step {step}: leaf {key!r} CRC mismatch "
                f"(got {crc:#010x}, manifest {rec['crc32']:#010x})")


def _leaf_from(arr: np.ndarray, target, placement=None):
    """One restored leaf shaped like ``target``: an int, or a tensor on the
    target's device in its dtype (with a split ``placement``, this rank's
    block of ``arr``)."""
    if isinstance(target, torch.Tensor):
        arr = np.asarray(arr, order="C")   # keeps 0-d (ascontiguousarray won't)
        if target.dtype == torch.bfloat16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if placement is not None and placement.split:
            from repro_torch.parallel.sharding import local_block

            t = local_block(t, placement)
            if t.shape != target.shape:
                raise ValueError(f"restore: this rank's block is "
                                 f"{tuple(t.shape)}, the target's "
                                 f"{tuple(target.shape)}")
        return t.to(device=target.device, dtype=target.dtype)
    return int(arr)


def _unflatten_into(tree, flat: dict[str, np.ndarray], shardings=None):
    """``tree``'s structure with every leaf replaced from ``flat`` (cut to
    this rank's blocks by ``shardings``, a placement tree of ``tree``)."""
    placed = {}
    if shardings is not None:
        from repro_torch.parallel.sharding import placements_by_path

        placed = placements_by_path(shardings)
    return tree_map_with_path(
        lambda path, leaf: _leaf_from(flat[_SEP.join(path)], leaf,
                                      placed.get(path)), tree)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, *,
                 fault_hook: Callable[[str, int], None] | None = None,
                 log: Callable[[str], None] = print):
        self.dir = directory
        self.keep = keep
        self.log = log
        self.fault_hook = fault_hook
        self._m = _ckpt_metrics()
        self._tracer = obs.tracer()
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._pending: threading.Thread | None = None
        # a writer killed mid-write leaves step_*.tmp behind; it can never
        # become visible (publish is a rename) but it wastes space and a
        # retried save at the same step must start clean
        for name in os.listdir(directory):
            if re.fullmatch(r"step_\d+\.tmp", name):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)

    def _fault(self, stage: str, step: int) -> None:
        if self.fault_hook is not None:
            self.fault_hook(stage, step)

    # -- discovery ----------------------------------------------------------
    def all_steps(self) -> list[int]:
        with self._lock:
            return self._all_steps_locked()

    def _all_steps_locked(self) -> list[int]:
        steps = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, "OK")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> dict:
        """The manifest saved beside a checkpoint: ``extra`` entries (the
        ladder's counters, controller state) ride here as JSON, so consumers
        can read them before building the restore target."""
        path = os.path.join(self.dir, f"step_{step}", "manifest.json")
        with open(path) as f:
            return json.load(f)

    # -- integrity ----------------------------------------------------------
    def _load_verified(self, step: int) -> dict[str, np.ndarray]:
        """Load step's flat arrays and verify them against the manifest.
        Checkpoints written before the integrity format (no ``"leaves"``
        record) load unverified."""
        base = os.path.join(self.dir, f"step_{step}")
        try:
            try:
                manifest = self.manifest(step)
                with np.load(os.path.join(base, "state.npz")) as z:
                    flat = {k: z[k] for k in z.files}
            except Exception as e:        # torn zip, missing file, bad json
                raise CheckpointCorruptError(
                    f"step {step}: unreadable checkpoint "
                    f"({type(e).__name__}: {e})") from e
            leaves = manifest.get("leaves")
            if leaves is not None:
                _check_integrity(step, flat, leaves)
        except CheckpointCorruptError as e:
            self._m["corrupt"].inc()
            self._tracer.instant("ckpt/corrupt", step=step, error=str(e))
            raise
        return flat

    def verify(self, step: int) -> None:
        """Raise :class:`CheckpointCorruptError` unless ``step`` loads and
        matches its manifest's per-leaf CRC32/shape/dtype record."""
        t0 = time.perf_counter()
        with self._tracer.span("ckpt/verify", step=step):
            self._load_verified(step)
        self._m["verify_s"].observe(time.perf_counter() - t0)

    def quarantine(self, step: int) -> str:
        """Move a corrupt checkpoint aside (``step_N.corrupt``) so
        discovery never offers it again; returns the new path."""
        with self._lock:
            src = os.path.join(self.dir, f"step_{step}")
            dst = src + ".corrupt"
            n = 0
            while os.path.exists(dst):
                n += 1
                dst = f"{src}.corrupt{n}"
            os.rename(src, dst)
        self.log(f"[ckpt] quarantined corrupt checkpoint step {step} "
                 f"-> {os.path.basename(dst)}")
        return dst

    def latest_verified_step(self, *, quarantine: bool = True) -> int | None:
        """Newest step that passes verification, walking backwards through
        the retained checkpoints; corrupt ones are quarantined."""
        for step in reversed(self.all_steps()):
            try:
                self.verify(step)
                return step
            except CheckpointCorruptError as e:
                self.log(f"[ckpt] verification failed: {e}")
                if quarantine:
                    self.quarantine(step)
        return None

    # -- save ---------------------------------------------------------------
    def _write(self, step: int, flat: dict[str, np.ndarray],
               dtypes: dict[str, str], extra: dict | None) -> None:
        t0 = time.perf_counter()
        with self._tracer.span("ckpt/write", step=step,
                               mb=round(_nbytes(flat) / 2**20, 2)):
            self._write_inner(step, flat, dtypes, extra)
        self._m["save_s"].observe(time.perf_counter() - t0)
        self._m["bytes_written"].inc(_nbytes(flat))
        self._m["saves"].inc()

    def _write_inner(self, step: int, flat: dict[str, np.ndarray],
                     dtypes: dict[str, str], extra: dict | None) -> None:
        final = os.path.join(self.dir, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        self._fault("pre_write", step)
        np.savez(os.path.join(tmp, "state.npz"), **flat)
        manifest = {"step": int(step), "format": 2,
                    "leaves": _integrity(flat, dtypes), **(extra or {})}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        self._fault("mid_write", step)
        with open(os.path.join(tmp, "OK"), "w") as f:
            f.write("ok")
        self._fault("pre_publish", step)
        with self._lock:
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)       # atomic publish
            self._gc_locked()
        self._fault("published", step)

    def save(self, step: int, state: Any, extra: dict | None = None):
        """Synchronous atomic save (drains any pending async writer first:
        two writers GC'ing the same directory would tear keep-k)."""
        self.wait()
        self._write(step, *_flatten(state), extra)

    def async_save(self, step: int, state: Any, extra: dict | None = None):
        """The device -> host copy happens on the caller's thread (the
        snapshot is the state as of this call); the disk IO on a writer
        thread."""
        t0 = time.perf_counter()
        with self._tracer.span("ckpt/snapshot", step=step):
            flat, dtypes = _flatten(state)      # snapshot now
        self._m["snapshot_s"].observe(time.perf_counter() - t0)
        self.wait()

        def _bg():
            try:
                self._write(step, flat, dtypes, extra)
            except _WriterInterrupt:
                # chaos harness killed the writer mid-write: the torn
                # step_*.tmp stays behind (startup sweeps it), the
                # published checkpoints are untouched
                pass

        self._pending = threading.Thread(target=_bg, daemon=True)
        self._pending.start()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc_locked(self):
        steps = self._all_steps_locked()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def restore(self, step: int, target: Any, shardings: Any | None = None):
        """Restore into the structure of ``target`` (a state tree of
        tensors and ints), on its devices and in its dtypes,
        verifying the loaded bytes against the manifest
        (:class:`CheckpointCorruptError` on mismatch). ``shardings``: a
        placement tree of ``target`` (``parallel.sharding.
        train_state_specs``) re-partitioning the whole saved arrays onto
        the active mesh: each split leaf restores as this rank's block."""
        t0 = time.perf_counter()
        with self._tracer.span("ckpt/restore", step=step):
            flat = self._load_verified(step)
            tree = _unflatten_into(target, flat, shardings)
        self._m["restore_s"].observe(time.perf_counter() - t0)
        self._m["bytes_read"].inc(_nbytes(flat))
        self._m["restores"].inc()
        return tree

    def restore_latest(self, target: Any, shardings: Any | None = None):
        """Restore the newest checkpoint that passes verification, falling
        back through older ones (corrupt ones are quarantined). Returns
        ``(None, None)`` when nothing verifiable remains."""
        step = self.latest_verified_step()
        if step is None:
            return None, None
        return step, self.restore(step, target, shardings)


class _WriterInterrupt(BaseException):
    """Raised by a chaos fault hook to kill the async writer mid-write (the
    in-process stand-in for SIGKILL'ing the host at that instant)."""
