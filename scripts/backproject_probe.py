#!/usr/bin/env python3
"""Time ``ns_apply`` and the colgathers of one source tree on one CUDA card,
each held to its plain version first.

    python3 scripts/backproject_probe.py [--tree DIR] [--label NAME] [--rates]
                                         [--steps [PATH ...]]

``--tree`` names another checkout (for example a parent commit unpacked
with ``git archive`` into ``build/``) whose ``src/repro_torch`` is imported
in place of this one's; the shapes, inputs and timers are this checkout's
``chip_smoke.py`` helpers, and the wrappers are called through the public
signatures both trees have. To compare two trees on one card, run them in
turns in one command (A, B, B, A): the kernels of each tree build into its
own ``build/``.

* ``ns_apply`` per Trion step of llama-350m (35 launches: 20 at the wide
  factor (24, 128, 1024), 15 at (24, 128, 2816)): the kernel and
  ``torch.baddbmm(x, p, x, beta=a)`` (full fp32, no TF32), each as eager
  calls (CUDA events around 10 calls) and as CUDA-graph replays of a step's
  launches of each shape (the device time without the wrapper's host work);
  TFLOP/s of each beside the card's FFMA rate.
* ``colgather_matmul_dual`` and ``colgather_matmul`` in fp32, bf16 and
  int8 per DCT-AdamW step (7 launches: 4 at b (24, 1024, 128), 3 at (24,
  2816, 128), Q^T (1024, 1024)): int8 as the kernel alone on quantized
  operands and as the wrapper with its operand quantization; fp32 and bf16
  beside their yardstick, the gather and cuBLAS (fp32: ``torch.matmul`` of
  the stacked operands, three calls; bf16: ``torch.matmul(b.bfloat16(),
  qt[idx].bfloat16())``, two calls, bf16 outputs); GB/s of each against
  the bytes of the function (fp32 outputs) and TFLOP/s.

``--rates`` first measures the card's FFMA rate and ``mma.sync``'s bf16
rate (``scripts/dct_project_probe.py --rates`` and
``scripts/tf32_mma_probe.py``, built with ``nvcc``), the ceilings of the two
kinds of kernel at this card's clock. ``--steps`` then runs
``chip_smoke.time_breakdown`` for the named steps of llama-350m (``trion``,
DCT-AdamW in ``fp32``, ``bf16``, ``int8``; all four when none is named):
the step's parts alone, and its device busy time and kernel launches under
``torch.profiler``, the layer above the kernels.

Prints one JSON line per measurement and a ``probe_summary`` line.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPS = ("trion", "fp32", "bf16", "int8")


def _rates() -> None:
    sys.path.insert(0, str(ROOT / "scripts"))
    import dct_project_probe

    dct_project_probe._rates()
    subprocess.run([sys.executable, str(ROOT / "scripts" / "tf32_mma_probe.py")],
                   check=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT),
                    help="checkout whose src/repro_torch is measured")
    ap.add_argument("--label", default=None)
    ap.add_argument("--rates", action="store_true",
                    help="first measure the card's FFMA and bf16 mma rates")
    ap.add_argument("--steps", nargs="*", choices=STEPS, default=None,
                    help="then break down these steps (all when none named)")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("backproject_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    from repro_torch.core.dct import dct2_matrix
    from repro_torch.core.newton_schulz import NS_COEFFS
    from repro_torch.core.selection import select_top_r
    cg = importlib.import_module("repro_torch.kernels.colgather_matmul")
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import newton_schulz as ns

    assert Path(cuda_lib.__file__).resolve().is_relative_to(tree), \
        cuda_lib.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    # each precision's bar against its plain version (relative to max
    # |out|; int8 bit-equal) and the peak its bound is taken at
    bars = {"fp32": 1e-5, "bf16": cs.LOWP_TC_RTOL, "int8": 0.0}
    peaks = {"fp32": cs.PEAK_FP32_PER_S, "bf16": cs.PEAK_BF16_PER_S,
             "int8": cs.PEAK_INT8_PER_S}
    label = args.label or str(tree)
    print(json.dumps({"probe": label, "card": cs._device_line()}), flush=True)
    if args.rates:
        _rates()
    cuda_lib.library()
    print("\n".join(line for line in cuda_lib.build_log().splitlines()
                    if "registers" in line or "Compiling entry" in line
                    or "spill" in line), flush=True)

    gen = torch.Generator(device=dev).manual_seed(6)
    a, b, c = NS_COEFFS
    keys = ("apply_eager_ms", "apply_graph_ms", "baddbmm_eager_ms",
            "baddbmm_graph_ms", "apply_bound_ms")
    step = dict.fromkeys(keys, 0.0)
    flops = {"apply": 0.0}
    nbytes = {}
    for (nb, m, n), per_step in cs.MAIN_SHAPES:
        r = cs.RANK
        launches = per_step * cs.NS_STEPS
        x = torch.randn((nb, r, m), generator=gen, device=dev)
        x /= torch.linalg.norm(x, dim=(-2, -1), keepdim=True)
        g = ns.ns_gram_plain(x)
        p = b * g + c * torch.matmul(g, g)
        y = ns.ns_apply(x, p, a=a)
        y_p = ns.ns_apply_plain(x, p, a)
        err = cs._rel(y, y_p)
        assert err <= cs.NS_RTOL, (m, err)
        assert torch.equal(y, ns.ns_apply(x, p, a=a)), m
        apply_flops = 2.0 * nb * r * r * m + 2.0 * nb * r * m
        row = {
            "apply_eager_ms": cs._time_ms(lambda: ns.ns_apply(x, p, a=a, out=y)),
            "apply_graph_ms": cs._graph_ms(
                lambda: ns.ns_apply(x, p, a=a, out=y), launches),
            "baddbmm_eager_ms": cs._time_ms(
                lambda: torch.baddbmm(x, p, x, beta=a)),
            "baddbmm_graph_ms": cs._graph_ms(
                lambda: torch.baddbmm(x, p, x, beta=a), launches),
            "apply_bound_ms": cs._bound_ms(4.0 * nb * (2 * r * m + r * r),
                                           apply_flops)[0]}
        print(json.dumps({"ns_apply_wide": [nb, r, m], "per_call": row,
                          "rel_err": err, "launches_per_step": launches,
                          "tflop_per_s": {k: apply_flops / row[k] / 1e9 for k in
                                          ("apply_eager_ms", "apply_graph_ms",
                                           "baddbmm_eager_ms",
                                           "baddbmm_graph_ms")}}),
              flush=True)
        for k, v in row.items():
            step[k] += launches * v
        flops["apply"] += launches * apply_flops
        del x, g, p, y, y_p

        # the back-projections in each precision
        qt = dct2_matrix(n, device=dev).T.contiguous()
        idx = select_top_r(torch.rand((nb, n), generator=gen, device=dev), r)
        b1 = torch.randn((nb, m, r), generator=gen, device=dev)
        b2 = torch.randn((nb, m, r), generator=gen, device=dev)
        idx_l = idx.long()
        rows_needed = torch.unique(idx).numel()
        e = nb * m * n
        ((q1, s1), (q2, s2)), qt_q = cg.quantize_operands((b1, b2), qt, idx)
        for dt in ("fp32", "bf16", "int8"):
            outs = cg.colgather_matmul_dual(b1, b2, qt, idx, compute_dtype=dt)
            want = cg.colgather_matmul_dual_plain(b1, b2, qt, idx,
                                                  compute_dtype=dt)
            single = cg.colgather_matmul(b1, qt, idx, compute_dtype=dt)
            errs = [cs._rel(o, w) for o, w in zip((*outs, single),
                                                   (*want, want[0]))]
            assert max(errs) <= bars[dt], (dt, m, errs)
            del outs, want, single
            row = {
                "dual_ms": cs._time_ms(lambda: cg.colgather_matmul_dual(
                    b1, b2, qt, idx, compute_dtype=dt)),
                "single_ms": cs._time_ms(lambda: cg.colgather_matmul(
                    b1, qt, idx, compute_dtype=dt))}
            if dt == "int8":
                # the wrapper's times above; the kernels alone here
                row["dual_wrapper_ms"] = row["dual_ms"]
                row["single_wrapper_ms"] = row["single_ms"]
                row["dual_ms"] = cs._time_ms(lambda: cg.colgather_matmul_dual_q8(
                    q1, s1, q2, s2, qt_q, idx))
                row["single_ms"] = cs._time_ms(lambda: cg.colgather_matmul_q8(
                    q1, s1, qt_q, idx))
            elif dt == "fp32":
                row["dual_gather_cublas_ms"] = cs._time_ms(
                    lambda: torch.matmul(torch.stack((b1, b2)), qt[idx_l]))
                row["single_gather_cublas_ms"] = cs._time_ms(
                    lambda: torch.matmul(b1, qt[idx_l]))
            else:
                def gather_cublas(bs):
                    rows16 = qt[idx_l].bfloat16()
                    return tuple(torch.matmul(v.bfloat16(), rows16)
                                 for v in bs)
                row["dual_gather_cublas_ms"] = cs._time_ms(
                    lambda: gather_cublas((b1, b2)))
                row["single_gather_cublas_ms"] = cs._time_ms(
                    lambda: gather_cublas((b1,)))
            for ops_n, name in ((2, "dual"), (1, "single")):
                if dt == "int8":      # int8 codes and row scales in
                    by = ops_n * (1.0 * nb * m * r + 4.0 * nb * m) \
                        + 1.0 * rows_needed * n + 4.0 * nb * r + 4.0 * ops_n * e
                else:
                    by = 4.0 * (ops_n * nb * m * r + rows_needed * n + nb * r
                                + ops_n * e)
                fl = ops_n * 2.0 * e * r
                row[f"{name}_bound_ms"] = cs._bound_ms(by, fl, peaks[dt])[0]
                key = f"{dt}_{name}"
                nbytes[key] = nbytes.get(key, 0.0) + per_step * by
                flops[key] = flops.get(key, 0.0) + per_step * fl
                print(json.dumps({
                    f"colgather_{key}": [nb, m, r, n],
                    "gb_per_s": by / row[f"{name}_ms"] / 1e6,
                    "tflop_per_s": fl / row[f"{name}_ms"] / 1e9}), flush=True)
            print(json.dumps({f"colgather_{dt}_shape": [nb, m, r, n],
                              "per_call": row, "rel_errs": errs}), flush=True)
            for k, v in row.items():
                step[f"{dt}_{k}"] = step.get(f"{dt}_{k}", 0.0) + per_step * v
        del b1, b2, qt, q1, q2, qt_q
        torch.cuda.empty_cache()
    print(json.dumps({
        "probe_summary": label, "card": cs._device_line(),
        "per_step_ms": step,
        "ns_apply_graph_vs_baddbmm_graph": step["apply_graph_ms"]
        / step["baddbmm_graph_ms"],
        "ns_apply_tflop_per_s_graph": flops["apply"] / step["apply_graph_ms"]
        / 1e9,
        "colgather_gb_per_s": {k: v / step[f"{k}_ms"] / 1e6
                               for k, v in nbytes.items()},
        "colgather_tflop_per_s": {k: v / step[f"{k}_ms"] / 1e9
                                  for k, v in flops.items() if k != "apply"}}),
        flush=True)
    for name in STEPS if args.steps == [] else args.steps or ():
        if name == "trion":
            cs.time_breakdown(torch, dev, "trion")
        else:
            cs.time_breakdown(torch, dev, compute_dtype=name)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
