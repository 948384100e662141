"""The serving CLI's ``--metrics`` report (the JAX package's
``examples/serve_batch.py --metrics``): the obs layer enabled before the
engine is built, the per-request latency table, TTFT / ITL quantiles, and
``metrics.prom`` and ``trace.json`` written and parsed; the dense engine
refused with the reference's message."""
import json
from pathlib import Path

import pytest

from repro_torch import obs
from repro_torch.launch import serve as serve_cli

ROOT = Path(__file__).resolve().parents[1]
ARGV = ["--smoke", "--device", "cpu", "--engine", "paged", "--metrics"]


@pytest.fixture
def obs_off_after():
    """The obs layer is process-wide: start from empty series, and leave it
    off and empty for the next test."""
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _prom_samples(path: Path) -> dict[str, float]:
    """``{series: value}`` of a Prometheus text file (labels kept in the
    series name); every sample line must parse."""
    out = {}
    for line in path.read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        series, value = line.rsplit(" ", 1)
        out[series] = float(value)
    return out


def test_metrics_report_files_and_counts(tmp_path, capsys, obs_off_after):
    res = serve_cli.run(serve_cli.build([*ARGV, "--metrics-dir",
                                         str(tmp_path)]))
    out = capsys.readouterr().out
    assert obs.enabled()
    handles = res["handles"].values()
    served = sum(1 for h in handles if h.tokens)
    assert served >= 3

    prom = _prom_samples(tmp_path / "metrics.prom")
    assert prom["serve_ttft_seconds_count"] == served
    assert prom["serve_tokens_total"] == sum(len(h.tokens) for h in handles)
    assert prom["serve_itl_seconds_count"] == sum(
        max(len(h.tokens) - 1, 0) for h in handles)
    assert prom['serve_ttft_seconds_bucket{le="+Inf"}'] == served

    trace = json.loads((tmp_path / "trace.json").read_text())
    names = [e["name"] for e in trace["traceEvents"]]
    assert names.count("serve/decode_step") == res["stats"]["steps"] > 0
    assert names.count("serve/admit") == served

    # the table (one row a request) and the quantiles
    assert "per-request latency" in out
    for h in handles:
        assert h.request.request_id in out.split("per-request latency")[1]
    q = res["metrics"]
    assert 0 < q["ttft_p50"] <= q["ttft_p99"]
    assert 0 < q["itl_p50"] <= q["itl_p99"]
    assert (f"ttft p50/p99: {q['ttft_p50']:.3f}/{q['ttft_p99']:.3f}"
            in out)
    assert "kernel launches: flash_decode=0" in out


def test_without_metrics_obs_stays_off(tmp_path, capsys, obs_off_after):
    res = serve_cli.run(serve_cli.build(["--smoke", "--device", "cpu",
                                         "--metrics-dir", str(tmp_path)]))
    assert "metrics" not in res and not obs.enabled()
    assert not (tmp_path / "metrics.prom").exists()
    assert "per-request latency" not in capsys.readouterr().out


def test_metrics_with_dense_engine_exits_as_the_reference(obs_off_after):
    with pytest.raises(SystemExit) as err:
        serve_cli.main(["--smoke", "--device", "cpu", "--engine", "dense",
                        "--metrics"])
    assert err.value.code == ("--metrics instruments the paged engine; "
                              "use --engine paged")
    # the JAX example's own message (its two string pieces)
    ref = (ROOT / "examples" / "serve_batch.py").read_text()
    assert '"--metrics instruments the paged engine; "' in ref
    assert '"use --engine paged"' in ref
    assert not obs.enabled()
