#!/usr/bin/env python3
"""Every CUDA kernel of the port once at small ragged shapes, under NVIDIA's
``compute-sanitizer`` where the machine has it.

    python3 scripts/sanitize_kernels.py [--launch | --int8-discard]

With no option it runs itself with ``PYTORCH_NO_CUDA_MEMORY_CACHING=1`` (so
the caching allocator's pooled blocks cannot hide an access past an
allocation): ``--launch`` under ``compute-sanitizer --tool memcheck`` and
``--tool racecheck``, and ``--int8-discard`` under ``--tool initcheck``. It
prints one JSON line per run (the tool, its exit code, whether the
sanitizer attached, its ``ERROR SUMMARY`` line and its first reports) and
exits non-zero if any run that counts failed. Where no ``compute-sanitizer``
is found, or it attaches to no run (it refuses a device it does not
support), it says so and runs both parts without it, and those runs count.

* ``--launch``: each kernel wrapper on CUDA tensors at small ragged shapes
  (rows, columns and ranks off every tile, operands 4 bytes off 16 for the
  4-byte copy paths), each output held to its plain version; the
  colgathers with indices outside [0, n) (a zero row of Q^T). Then the fp32
  and int8 colgathers and the int8 colgather's quantizers once more through
  their C entry points, each output inside a buffer whose ``GUARD``
  elements on either side are poisoned and must be untouched after the
  launch (outputs on 16 bytes, then 4 bytes off: the 4-byte stores), and
  ``ns_gram`` the same way at each of its ragged shapes, its workspace of
  partial sums between poisoned guards too.
  This is a memory check; the tests hold the numeric tolerances.
* ``--int8-discard``: DCT-AdamW in int8 without error feedback
  (``chip_smoke.py`` phase 11's "int8 discard" path) on llama-350m at full
  width with its depth cut to one layer, 2 steps of batch 2 x 128.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOOLS = (("memcheck", "--launch"), ("racecheck", "--launch"),
         ("initcheck", "--int8-discard"))
RUN_TIMEOUT_S = 420
# poisoned elements on either side of a guarded output; the fp32 poison (a
# NaN) as int32 bits, the int8 one
GUARD = 64
POISON_F32, POISON_I8 = 0x7FC0DEAD, 0x5A


def _sanitizer() -> str | None:
    for path in (shutil.which("compute-sanitizer"),
                 "/usr/local/cuda/bin/compute-sanitizer",
                 "/usr/local/cuda/compute-sanitizer/compute-sanitizer"):
        if path and os.path.exists(path):
            return path
    return None


def _run(argv: list[str]) -> tuple[int, str]:
    env = {**os.environ, "PYTORCH_NO_CUDA_MEMORY_CACHING": "1"}
    try:
        out = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=RUN_TIMEOUT_S)
    except subprocess.TimeoutExpired as err:
        return 124, f"timed out after {RUN_TIMEOUT_S} s: {err.stdout or ''}"
    return out.returncode, out.stdout + out.stderr


def _report(tool: str | None, part: str, rc: int, log: str) -> dict:
    summary = re.findall(r"=+ (?:ERROR SUMMARY|RACECHECK SUMMARY).*", log)
    reports = [line for line in log.splitlines()
               if line.startswith("=========") and "SUMMARY" not in line]
    row = {"tool": tool or "none", "part": part, "rc": rc,
           "attached": tool is not None and "Device not supported" not in log,
           "summary": summary, "first_reports": reports[:12],
           "tail": log[-1500:] if rc else log[-300:]}
    print(json.dumps(row), flush=True)
    return row


def supervise() -> int:
    from repro_torch.kernels import cuda_lib
    cuda_lib.library()          # built here, so the sanitized runs only load it
    me = [sys.executable, str(Path(__file__).resolve())]
    tool_path = _sanitizer()
    rows = []
    if tool_path is None:
        print(json.dumps({"compute_sanitizer": "not found on PATH or under "
                          "/usr/local/cuda"}), flush=True)
    else:
        for tool, part in TOOLS:
            rc, log = _run([tool_path, "--tool", tool, "--error-exitcode", "3",
                            *me, part])
            rows.append(_report(tool, part, rc, log))
    # without a sanitizer that attached, the launches still run and are held
    # to their plain versions
    if not any(r["attached"] for r in rows):
        for part in ("--launch", "--int8-discard"):
            rows.append(_report(None, part, *_run(me + [part])))
    counted = [r for r in rows if r["attached"] or r["tool"] == "none"]
    ok = all(r["rc"] == 0 for r in counted)
    print(json.dumps({"sanitize_summary": {
        "ok": ok, "sanitizer": tool_path,
        "attached": any(r["attached"] for r in rows),
        "runs": {f"{r['tool']} {r['part']}": r["rc"] for r in rows}}}),
        flush=True)
    return 0 if ok else 1


def _close(got, want, rtol: float, name: str) -> None:
    import torch
    got, want = got.float(), want.float()
    scale = want.abs().max().item() or 1.0
    err = (got - want).abs().max().item()
    assert err <= rtol * scale and torch.isfinite(got).all(), (name, err)


def _poisoned(shape, dtype, offset: int):
    """A tensor of ``shape`` inside a buffer whose GUARD + ``offset``
    elements before it and GUARD after hold the poison: (buffer, view)."""
    import numpy as np
    import torch
    numel, lead = int(np.prod(shape)), GUARD + offset
    buf = torch.empty(lead + numel + GUARD, dtype=dtype, device="cuda")
    if dtype == torch.int8:
        buf.fill_(POISON_I8)
    else:
        buf.view(torch.int32).fill_(POISON_F32)
    return buf, buf[lead:lead + numel].view(shape)


def _guards_intact(buf, offset: int) -> bool:
    import torch
    ends = torch.cat([buf[:GUARD + offset], buf[-GUARD:]])
    if ends.dtype == torch.int8:
        return bool((ends == POISON_I8).all())
    return bool((ends.view(torch.int32) == POISON_F32).all())


def guarded_gathers(b1, b2, qt, idx, offset: int) -> None:
    """The fp32 and int8 colgathers (dual and single) and the int8 route's
    quantizers through their C entry points, each output in a poisoned
    buffer: equal to the wrappers' outputs, the poison intact."""
    import numpy as np
    import torch

    cg = importlib.import_module("repro_torch.kernels.colgather_matmul")
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import quant_ef as qe

    lib, st = cuda_lib.library(), cuda_lib.stream(qt)
    *batch, m, r = b1.shape
    nb, n = int(np.prod(batch)), qt.shape[0]
    f32, i8 = torch.float32, torch.int8
    ((q1, s1), (q2, s2)), qt_q = cg.quantize_operands((b1, b2), qt, idx)
    s_qt = qe.quant_qt_q8(qt)[1]
    want32 = cg.colgather_matmul_dual(b1, b2, qt, idx)
    want8 = cg.colgather_matmul_dual_q8(q1, s1, q2, s2, qt_q, idx)
    bufs = []

    def out(shape, dtype):
        buf, view = _poisoned(shape, dtype, offset)
        bufs.append(buf)
        return view
    ptr = [t.data_ptr() for t in (b1, b2, qt, idx, q1, s1, q2, s2, qt_q, s_qt)]
    pb1, pb2, pqt, pidx, pq1, ps1, pq2, ps2, pqtq, psqt = ptr
    o1, o2, o, p1, p2, p = (out((*batch, m, n), f32) for _ in range(6))
    c1, c2, cq = out(b1.shape, i8), out(b1.shape, i8), out(qt.shape, i8)
    t1, t2, tq = out((*batch, m, 1), f32), out((*batch, m, 1), f32), \
        out((n, 1), f32)
    for rc in (
            lib.repro_colgather_matmul_dual(pb1, pb2, pqt, pidx, o1.data_ptr(),
                                            o2.data_ptr(), nb, m, r, n, st),
            lib.repro_colgather_matmul(pb1, pqt, pidx, o.data_ptr(), nb, m, r,
                                       n, st),
            lib.repro_colgather_matmul_dual_q8(pq1, ps1, pq2, ps2, pqtq, pidx,
                                               p1.data_ptr(), p2.data_ptr(),
                                               nb, m, r, n, st),
            lib.repro_colgather_matmul_q8(pq1, ps1, pqtq, pidx, p.data_ptr(),
                                          nb, m, r, n, st),
            lib.repro_quant_fold_q8(pb1, pb2, psqt, pidx, c1.data_ptr(),
                                    c2.data_ptr(), t1.data_ptr(),
                                    t2.data_ptr(), nb * m, m, r, n, st),
            lib.repro_quant_qt_q8(pqt, cq.data_ptr(), tq.data_ptr(), n, n,
                                  st)):
        assert rc == 0, rc
    torch.cuda.synchronize()
    pairs = {"fp32 dual": ((o1, o2), want32), "fp32 single": ((o,), want32),
             "int8 dual": ((p1, p2), want8), "int8 single": ((p,), want8),
             "quant_fold_q8": ((c1, t1, c2, t2), (q1, s1, q2, s2)),
             "quant_qt_q8": ((cq, tq), (qt_q, s_qt))}
    for name, (got, want) in pairs.items():
        assert all(map(torch.equal, got, want)), name
    assert all(_guards_intact(b, offset) for b in bufs), \
        f"a guarded output's poison was overwritten (offset {offset})"


def guarded_gram(x, offset: int) -> None:
    """``ns_gram`` through its C entry point (the wrapper's split) into a
    poisoned output and a poisoned workspace: equal to the wrapper's
    output, the poison of both intact."""
    import torch

    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import newton_schulz as ns

    *batch, r, m = x.shape
    nb = x.numel() // (r * m)
    want = ns.ns_gram(x)
    splits, width = ns.ns_gram_splits(nb, r, m)
    buf, out = _poisoned((*batch, r, r), torch.float32, offset)
    wbuf, ws = _poisoned((ns.ns_gram_workspace_floats(nb, r, splits),),
                         torch.float32, 0)
    rc = cuda_lib.library().repro_ns_gram(x.data_ptr(), out.data_ptr(),
                                          ws.data_ptr(), nb, r, m, splits,
                                          width, cuda_lib.stream(x))
    assert rc == 0, rc
    torch.cuda.synchronize()
    assert torch.equal(out, want), "ns_gram"
    assert _guards_intact(buf, offset) and _guards_intact(wbuf, 0), \
        f"ns_gram's poison was overwritten (offset {offset})"


def launch() -> int:
    """Each wrapper once (the int8 and bf16 ones through their public
    routes), at ragged shapes, held to its plain version."""
    import numpy as np
    import torch

    from repro_torch.core.dct import dct2_matrix
    from repro_torch.core.newton_schulz import NS_COEFFS
    cg = importlib.import_module("repro_torch.kernels.colgather_matmul")
    dp = importlib.import_module("repro_torch.kernels.dct_project")
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    from repro_torch.kernels import lowp
    from repro_torch.kernels import newton_schulz as ns
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_ef as qe

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)

    def rand(*shape, offset=0):
        flat = torch.zeros(offset + int(np.prod(shape)), device=dev)
        flat[offset:] = torch.from_numpy(
            rng.standard_normal(int(np.prod(shape))).astype(np.float32))
        return flat[offset:].view(shape)

    def indices(batch, n, r):
        return torch.from_numpy(np.stack([np.sort(rng.permutation(n)[:r])
                                          for _ in range(batch)]
                                         ).astype(np.int32)).to(dev)

    ops.reset_launch_counts()
    for offset in (0, 1):
        g = rand(2, 129, 131, offset=offset)
        q = dct2_matrix(131, device=dev)
        qk, sk = qe.quantize_ef(g)
        qp, sp = qe.quantize_ef_plain(g)
        assert torch.equal(sk, sp) and (qk.int() - qp.int()).abs().max() <= 1
        _close(qe.dequant_add_ef(g, qk, sk), qe.dequant_add_ef_plain(g, qk, sk),
               1e-6, "dequant_add_ef")
        for dt, tol in (("fp32", 1e-5), ("bf16", 4e-6)):
            _close(dp.dct_project(g, q, compute_dtype=dt)[0],
                   dp.dct_project_plain(g, q, compute_dtype=dt)[0], tol,
                   f"dct_project {dt}")
        s, _ = dp.dct_project(g, q, compute_dtype="int8")
        want, _ = dp.dct_project_q8_plain(*lowp.quant_rows(g),
                                          *lowp.quant_cols(q))
        assert torch.equal(s, want), "dct_project int8"
        qt = q.T.contiguous()
        # a bad index gathers a zero row: the plain versions on Q^T with a
        # zero row appended, the bad indices pointing at it
        qt_zero = torch.cat([qt, torch.zeros_like(qt[:1])])
        for r in (17, 40):
            bad = indices(2, 131, r)
            bad[0, 0], bad[1, 1] = -1, 131
            rows = torch.where((bad < 0) | (bad >= 131), 131, bad)
            b1, b2 = rand(2, 129, r, offset=offset), rand(2, 129, r)
            for dt, tol in (("fp32", 1e-5), ("bf16", 4e-6), ("int8", 0.0)):
                outs = cg.colgather_matmul_dual(b1, b2, qt, bad,
                                                compute_dtype=dt)
                want = lowp.lowp_gather_matmul((b1, b2), qt_zero, rows, dt)
                single = cg.colgather_matmul(b1, qt, bad, compute_dtype=dt)
                for o, w in zip((*outs, single), (*want, want[0])):
                    _close(o, w, tol, f"colgather_matmul {dt}")
            guarded_gathers(b1, b2, qt, bad, offset)
        # r and n multiples of 16: the 16-byte copies of both precisions
        q256 = dct2_matrix(256, device=dev).T.contiguous()
        bad = indices(2, 256, 32)
        bad[0, 3], bad[1, 0] = 256, -7
        guarded_gathers(rand(2, 129, 32), rand(2, 129, 32), q256, bad, offset)
        a, b, c = NS_COEFFS
        for r, m in ((17, 100), (45, 333), (300, 301), (128, 1030),
                     (8, 1)):
            x = rand(2, r, m)
            x = (x / torch.linalg.norm(x, dim=(-2, -1), keepdim=True)).cpu()
            x = rand(2, r, m, offset=offset).copy_(x)
            gram = ns.ns_gram(x)
            _close(gram, ns.ns_gram_plain(x), 1e-5, "ns_gram")
            guarded_gram(x, offset)
            p = b * gram + c * gram @ gram
            _close(ns.ns_apply(x, p, a=a), ns.ns_apply_plain(x, p, a), 1e-5,
                   "ns_apply")
    # attention: ragged sequence, GQA, a window
    for dtype in (torch.float32, torch.bfloat16):
        q = rand(2, 77, 4, 64).to(dtype)
        k, v = rand(2, 77, 2, 64).to(dtype), rand(2, 77, 2, 64).to(dtype)
        _close(fa.flash_attention(q, k, v, causal=True, window=33),
               fa.flash_attention_ref(q, k, v, causal=True, window=33),
               3e-5 if dtype == torch.float32 else 1e-2, "flash_attention")
    q16 = rand(2, 77, 4, 64).to(torch.bfloat16)
    k16, v16 = rand(2, 77, 2, 64).to(torch.bfloat16), \
        rand(2, 77, 2, 64).to(torch.bfloat16)
    _close(fa.flash_attention_blockwise(q16, k16, v16, window=33, kv_chunk=32),
           fa.blockwise_attention_ref(q16, k16, v16, causal=True, window=33,
                                      kv_chunk=32), 1e-2,
           "flash_attention_blockwise")
    lengths = [37, 0, 16]
    table = torch.zeros(3, 4, dtype=torch.int32, device=dev)
    table[0, :3] = torch.tensor([1, 4, 2])
    table[2, :1] = 3
    kp = rand(6, 16, 2, 64).to(torch.bfloat16)
    vp = rand(6, 16, 2, 64).to(torch.bfloat16)
    qd = rand(3, 8, 64)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    for splits in (1, 2):
        _close(fd.flash_decode(qd, kp, vp, table, ln, window=20,
                               num_splits=splits),
               fd.flash_decode_plain(qd, kp, vp, table, ln, window=20,
                                     num_splits=splits), 1e-5, "flash_decode")
    torch.cuda.synchronize()
    missing = [k for k, n in ops.launch_counts().items() if not n]
    print(json.dumps({"launched": ops.launch_counts(), "missing": missing}),
          flush=True)
    assert not missing, missing
    return 0


def int8_discard() -> int:
    """Phase 11's int8 path without error feedback, at a cut depth."""
    import dataclasses

    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import registry
    from repro_torch.launch import train as train_cli

    full = registry.get_config

    def one_layer(name, smoke=False):
        cfg = full(name, smoke=smoke)
        return dataclasses.replace(
            cfg, schedule=tuple((pattern, 1) for pattern, _ in cfg.schedule))
    registry.get_config = one_layer        # _run_api looks it up per call
    try:
        args = train_cli.build(["--arch", "llama-350m", "--optimizer",
                                "dct_adamw", "--rank", "128", "--steps", "2",
                                "--warmup", "1", "--batch", "2", "--seq-len",
                                "128", "--log-every", "1"])
        trainer = cs._run_api(args, {"error_feedback": False,
                                     "compute_dtype": "int8"})
    finally:
        registry.get_config = full
    torch.cuda.synchronize()
    losses = [h["loss"] for h in trainer.metrics_history]
    print(json.dumps({"int8_discard_losses": losses}), flush=True)
    assert all(math.isfinite(x) for x in losses), losses
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    part = ap.add_mutually_exclusive_group()
    part.add_argument("--launch", action="store_true")
    part.add_argument("--int8-discard", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("sanitize_kernels: no CUDA device", file=sys.stderr)
        return 1
    if args.launch:
        return launch()
    if args.int8_discard:
        return int8_discard()
    return supervise()


if __name__ == "__main__":
    sys.exit(main())
