"""The port's regression gate, Prometheus exposition and ``obs top``
(``obs/gate.py``, ``obs/promfmt.py``, ``obs/topview.py`` and the ``obs``
CLI's ``gate`` / ``top`` / ``alerts``) against the JAX package's, on the
CPU. All host logic.

- ``gate_row`` / ``format_gate`` equal to the JAX functions' on the
  committed ``BENCH_r*.json`` history and on synthetic histories; a card
  row (``platform='gpu'``, what the port writes on the card) bands against
  nothing in the committed history;
- ``promfmt.render`` and ``topview.render_table`` byte-equal to the JAX
  functions' on the same rollups;
- the CLI's ``gate``, ``top --iterations 1`` and ``alerts`` print what
  the JAX CLI prints on the same files.
"""

import glob
import json
from pathlib import Path

import pytest

from fakepta_tpu.obs import cli as jcli
from fakepta_tpu.obs import gate as jgate
from fakepta_tpu.obs import promfmt as jpromfmt
from fakepta_tpu.obs import topview as jtopview
from fakepta_tpu_torch.obs import cli, gate, promfmt, topview
from fakepta_tpu_torch.obs.report import RunReport
from fakepta_tpu_torch.obs.telemetry import AlertRules, TelemetryAggregator

REPO = Path(__file__).resolve().parents[1]
BENCH = sorted(glob.glob(str(REPO / "BENCH_r*.json")))


def _snap(seq, p99=5.0, t=None, **extra):
    snap = {"seq": seq, "epoch": "e1", "t": float(seq if t is None else t),
            "replica": "r0",
            "slo": {"serve_requests": seq * 2, "serve_failed": 0,
                    "serve_dispatches": seq, "qps_per_chip": 0.5,
                    "p50_ms": 1.0, "p99_ms": p99, "queue_depth": 1}}
    snap.update(extra)
    return snap


def _rollups():
    """A fleet-shaped rollup and a gateway/tenant-shaped one."""
    agg = TelemetryAggregator(alert_rules=AlertRules(p99_slo_ms=10.0))
    agg.ingest("r0", _snap(1, p99=50.0, pool={
        "entries": 2, "max_entries": 8, "builds": 1,
        "specs": {"abc123def4567890": {"warm_buckets": 3}}},
        streams={"s0": {"appends": 4, "append_mean_ms": 1.5}},
        live={"obs.peak_hbm_bytes": 9.0, "stream.refresh_gate_holds": 2,
              "sample.segments_done": 1, "flag": True}),
        health={"state": "healthy", "misses": 0, "breaker_open": False})
    agg.ingest("r0", _snap(3, p99=60.0))
    agg.ingest("r1-long-replica-name", _snap(2, p99=1.0),
               health={"state": "suspect", "misses": 2,
                       "breaker_open": True})
    agg.ingest("r2", _snap(1))
    agg.retire("r2")
    fleet = agg.rollup()
    gw = dict(fleet, gateway={"requests": 9, "hits": 3, "hit_rate": 1 / 3,
                              "coalesced": 2, "throttles": 1,
                              "device_s_saved": 0.25, "cache_rejects": 0,
                              "cutovers": 1},
              tenants={"acme": {"qps": 2.5, "requests": 6, "throttles": 1,
                                "hit_rate": 0.5, "queue_share": 0.75,
                                "p99_ms": 12.0},
                       'we"ird\\t': {"qps": 0.0, "requests": 0}})
    return {"fleet": fleet, "gateway": gw, "empty": {}}


@pytest.mark.parametrize("name", ["fleet", "gateway", "empty"])
def test_promfmt_and_topview_byte_equal_jax(name):
    rollup = _rollups()[name]
    assert promfmt.render(rollup) == jpromfmt.render(rollup)
    assert topview.render_table(rollup) == jtopview.render_table(rollup)
    assert promfmt.PROM_METRICS == jpromfmt.PROM_METRICS
    with pytest.raises(ValueError, match="not in the declared"):
        promfmt._sample([], "fakepta_surprise_metric", {}, 1.0)


def test_run_top_scripted_refresh_equals_jax():
    import io

    outs = []
    for mod in (topview, jtopview):
        fetches = iter([_rollups()["fleet"], _rollups()["gateway"]])

        def fetch(fetches=fetches):
            try:
                return next(fetches)
            except StopIteration:
                raise EOFError

        out = io.StringIO()
        frames = mod.run_top(fetch, interval_s=0.0, iterations=None,
                             out=out)
        outs.append((frames, out.getvalue()))
    assert outs[0] == outs[1] and outs[0][0] == 2


def _history_rows():
    return gate.load_history(BENCH, warn=lambda m: None)


SYNTH = [{"platform": "cpu", "value": 200.0 * j,
          "serve_qps_per_chip": 1000.0 * j, "serve_p99_ms": 20.0 / j,
          "queue_depth": 48, "rhat_max": 1.005, "accept_rate": 0.9,
          "compile_s": 3.0 * j, "scenario": None}
         for j in (0.97, 1.0, 1.02, 1.05)]


@pytest.mark.parametrize("case", ["bench_r05", "bench_halved",
                                  "bench_gpu", "synthetic",
                                  "synthetic_regressed", "scenario"])
def test_gate_row_and_format_equal_jax(case):
    if case.startswith("bench"):
        history = _history_rows()
        assert history == jgate.load_history(BENCH, warn=lambda m: None)
        row = dict(json.loads(Path(BENCH[-1]).read_text())["parsed"])
        if case == "bench_halved":
            row["value"] /= 2
        if case == "bench_gpu":
            row["platform"] = "gpu"
    else:
        history = SYNTH
        row = dict(SYNTH[1])
        if case == "synthetic_regressed":
            row.update(serve_qps_per_chip=400.0, serve_p99_ms=80.0,
                       queue_depth=300, accept_rate=0.1)
        if case == "scenario":
            row["scenario"] = "ng15"
    for kw in ({}, {"k": 1.0, "rel_floor": 0.0, "min_history": 3}):
        got = gate.gate_row(row, history, **kw)
        want = jgate.gate_row(row, history, **kw)
        assert [vars(r) for r in got] == [vars(r) for r in want]
        n = len([r for r in history
                 if r.get("platform") == row.get("platform")])
        assert gate.format_gate(got, row.get("platform"), n) == \
            jgate.format_gate(want, row.get("platform"), n)
    verdicts = {r.metric: r.verdict for r in got}
    if case == "bench_halved":
        assert verdicts["value"] == "regression"
    if case in ("bench_gpu", "scenario"):
        # a card row (or a new scenario) starts its own trajectory
        assert {r.n_history for r in got} == {0}
        assert set(verdicts.values()) == {"info"}
    if case == "synthetic_regressed":
        assert verdicts["serve_qps_per_chip"] == "regression"
        assert verdicts["serve_p99_ms"] == "regression"
        assert verdicts["queue_depth"] == "info"


def test_load_row_and_platform_fill_equal_jax(tmp_path):
    """Bench lines, wrapped records and RunReport files load alike; a
    platform-less row takes the gating machine's platform (here the CPU's,
    as the JAX gate's fingerprint gives); a saved card report keeps
    'gpu'."""
    wrapped = Path(BENCH[-1])
    assert gate.load_row(wrapped) == jgate.load_row(wrapped)
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps({"value": 3.0}))
    import torch
    here = "gpu" if torch.cuda.is_available() else "cpu"
    assert gate.load_row(bare) == {"value": 3.0, "platform": here}
    assert jgate.load_row(bare) == {"value": 3.0, "platform": "cpu"}
    rep = RunReport(meta={"kind": "serve", "platform": "gpu",
                          "extra_metrics": {"serve_p99_ms": 12.5}},
                    total_s=1.0)
    path = tmp_path / "serve.jsonl"
    rep.save(path)
    got, want = gate.load_row(path), jgate.load_row(path)
    assert got == want and got["platform"] == "gpu"
    assert got["serve_p99_ms"] == 12.5
    assert gate.resolve_history([str(tmp_path / "none*.json")]) == []
    assert gate.resolve_history(None) == jgate.resolve_history(None)


def _both(capsys, argv):
    """(rc, stdout) of the port's obs CLI and the JAX one on ``argv``."""
    out = []
    for mod in (cli, jcli):
        rc = mod.main(list(argv))
        out.append((rc, capsys.readouterr().out))
    return out


def test_cli_gate_prints_what_the_jax_cli_prints(tmp_path, capsys,
                                                  monkeypatch):
    monkeypatch.chdir(REPO)
    row = json.loads(Path(BENCH[-1]).read_text())["parsed"]
    cases = {"head": row, "bad": dict(row, value=row["value"] / 2),
             "gpu": dict(row, platform="gpu", value=48000.0)}
    for name, r in cases.items():
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(r))
        for extra in ([], ["--fail-on-regression"]):
            got, want = _both(capsys, ["gate", str(path), *extra])
            assert got == want, name
        if name == "bad":
            assert got[0] == 1 and "REGRESSION" in got[1]
        if name == "gpu":
            assert got[0] == 0 and "no comparable history" in got[1]
    hist = tmp_path / "HIST_r*.json"
    for i, r in enumerate(SYNTH):
        (tmp_path / f"HIST_r{i}.json").write_text(json.dumps(r))
    (tmp_path / "HIST_r9.json").write_text("{broken")
    got, want = _both(capsys, ["gate", str(tmp_path / "HIST_r1.json"),
                               "--history", str(hist), "--k", "2"])
    assert got == want and got[0] == 0


def test_cli_gate_on_a_saved_card_serve_report(tmp_path, capsys,
                                               monkeypatch):
    """The serve report a card pool saves gates against the committed
    history as the first row of its trajectory: exit 0, nothing banded."""
    monkeypatch.chdir(REPO)
    rep = RunReport(meta={"kind": "serve", "platform": "gpu",
                          "extra_metrics": {"serve_p99_ms": 12.5,
                                            "serve_qps_per_chip": 80.0}},
                    total_s=1.0)
    path = tmp_path / "serve.jsonl"
    rep.save(path)
    assert cli.main(["gate", str(path), "--fail-on-regression"]) == 0
    out = capsys.readouterr().out
    assert "no comparable history" in out and "platform='gpu'" in out


def test_cli_top_and_alerts_from_a_saved_log_equal_jax(tmp_path, capsys):
    agg = TelemetryAggregator(alert_rules=AlertRules(p99_slo_ms=10.0))
    agg.ingest("r0", _snap(1, p99=50.0))
    agg.ingest("r1", _snap(2, p99=5.0))
    path = str(tmp_path / "telemetry.jsonl")
    agg.save(path)
    for argv in (["top", path], ["top", path, "--iterations", "3"],
                 ["alerts", path], ["alerts", path, "--format", "json"]):
        got, want = _both(capsys, argv)
        assert got == want, argv
        assert got[0] == 0
    assert "p99_over_slo" in got[1]
    quiet = TelemetryAggregator()
    quiet.ingest("r0", _snap(1))
    qpath = str(tmp_path / "quiet.jsonl")
    quiet.save(qpath)
    got, want = _both(capsys, ["alerts", qpath])
    assert got == want == (0, "no alerts\n")
    assert cli.main(["top", str(tmp_path / "missing.jsonl")]) == 2
