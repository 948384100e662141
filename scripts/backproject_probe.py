#!/usr/bin/env python3
"""Time ``ns_apply`` and the bf16 colgathers of one source tree on one CUDA
card, each held to its plain version first.

    python3 scripts/backproject_probe.py [--tree DIR] [--label NAME] [--rates]
                                         [--steps]

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
* The bf16 ``colgather_matmul_dual`` and ``colgather_matmul`` per bf16
  DCT-AdamW step (7 launches: 4 at b (24, 1024, 128), 3 at (24, 2816,
  128), Q^T (1024, 1024)) beside their yardstick, the gather and cuBLAS
  (``torch.matmul(b.bfloat16(), qt[idx].bfloat16())``, two calls, bf16
  outputs); GB/s of each against the bytes of the function (fp32 outputs)
  and TFLOP/s beside ``mma.sync``'s bf16 rate.

``--rates`` first measures the card's FFMA rate and ``mma.sync``'s bf16
rate (``scripts/dct_project_probe.py --rates`` and
``scripts/tf32_mma_probe.py``, built with ``nvcc``), the ceilings of the two
kinds of kernel at this card's clock. ``--steps`` then runs
``chip_smoke.time_breakdown`` for a Trion step and a bf16 DCT-AdamW step
of llama-350m (the step's parts alone, and its device busy time and kernel
launches under ``torch.profiler``), the layer above the kernels.

Prints one JSON line per measurement and a ``probe_summary`` line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


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
    ap.add_argument("--steps", action="store_true",
                    help="then break down a Trion and a bf16 DCT-AdamW step")
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
    from repro_torch.kernels import colgather_matmul as cg
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import newton_schulz as ns

    assert Path(cuda_lib.__file__).resolve().is_relative_to(tree), \
        cuda_lib.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
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
            "baddbmm_graph_ms", "apply_bound_ms", "dual_ms", "single_ms",
            "dual_gather_cublas_ms", "single_gather_cublas_ms",
            "dual_bound_ms", "single_bound_ms")
    step = dict.fromkeys(keys, 0.0)
    flops = {"apply": 0.0, "dual": 0.0, "single": 0.0}
    nbytes = {"dual": 0.0, "single": 0.0}
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

        # the bf16 back-projections
        qt = dct2_matrix(n, device=dev).T.contiguous()
        idx = select_top_r(torch.rand((nb, n), generator=gen, device=dev), r)
        b1 = torch.randn((nb, m, r), generator=gen, device=dev)
        b2 = torch.randn((nb, m, r), generator=gen, device=dev)
        outs = cg.colgather_matmul_dual_bf16(b1, b2, qt, idx)
        want = cg.colgather_matmul_dual_plain(b1, b2, qt, idx,
                                              compute_dtype="bf16")
        errs = [cs._rel(o, w) for o, w in zip(outs, want)]
        assert max(errs) <= cs.LOWP_TC_RTOL, (m, errs)
        single = cg.colgather_matmul_bf16(b1, qt, idx)
        errs.append(cs._rel(single, want[0]))
        assert errs[-1] <= cs.LOWP_TC_RTOL, (m, errs)
        del outs, want, single
        idx_l = idx.long()

        def gather_cublas(bs):
            rows16 = qt[idx_l].bfloat16()
            return tuple(torch.matmul(v.bfloat16(), rows16) for v in bs)
        rows_needed = torch.unique(idx).numel()
        e = nb * m * n
        row = {
            "dual_ms": cs._time_ms(
                lambda: cg.colgather_matmul_dual_bf16(b1, b2, qt, idx)),
            "single_ms": cs._time_ms(
                lambda: cg.colgather_matmul_bf16(b1, qt, idx)),
            "dual_gather_cublas_ms": cs._time_ms(
                lambda: gather_cublas((b1, b2))),
            "single_gather_cublas_ms": cs._time_ms(
                lambda: gather_cublas((b1,)))}
        for ops_n, name in ((2, "dual"), (1, "single")):
            by = 4.0 * (ops_n * nb * m * r + rows_needed * n + nb * r
                        + ops_n * e)
            fl = ops_n * 2.0 * e * r
            row[f"{name}_bound_ms"] = cs._bound_ms(by, fl,
                                                   cs.PEAK_BF16_PER_S)[0]
            nbytes[name] += per_step * by
            flops[name] += per_step * fl
            print(json.dumps({
                f"colgather_bf16_{name}": [nb, m, r, n],
                "gb_per_s": by / row[f"{name}_ms"] / 1e6,
                "tflop_per_s": fl / row[f"{name}_ms"] / 1e9}), flush=True)
        print(json.dumps({"colgather_bf16_shape": [nb, m, r, n],
                          "per_call": row, "rel_errs": errs}), flush=True)
        for k, v in row.items():
            step[k] += per_step * v
        del b1, b2, qt
        torch.cuda.empty_cache()
    print(json.dumps({
        "probe_summary": label, "card": cs._device_line(),
        "per_step_ms": step,
        "ns_apply_graph_vs_baddbmm_graph": step["apply_graph_ms"]
        / step["baddbmm_graph_ms"],
        "ns_apply_tflop_per_s_graph": flops["apply"] / step["apply_graph_ms"]
        / 1e9,
        "dual_gb_per_s": nbytes["dual"] / step["dual_ms"] / 1e6,
        "single_gb_per_s": nbytes["single"] / step["single_ms"] / 1e6,
        "dual_tflop_per_s": flops["dual"] / step["dual_ms"] / 1e9,
        "single_tflop_per_s": flops["single"] / step["single_ms"] / 1e9}),
        flush=True)
    if args.steps:
        cs.time_breakdown(torch, dev, "trion")
        torch.cuda.empty_cache()
        cs.time_breakdown(torch, dev, compute_dtype="bf16")
    return 0


if __name__ == "__main__":
    sys.exit(main())
