"""The port's telemetry plane (``fakepta_tpu_torch.obs.telemetry``) against
the JAX package's, on the CPU.

The telemetry-only cases of tests/test_telemetry.py: every case drives the
JAX module and the port with the same snapshot sequence and holds the
port's rollups, watermark counters and alerts equal to JAX's (the epoch
nonces and the monotonic clock excepted), then checks the case's own
claims. Then the port's publish sites: the sampler's segment drain
(``sample.segments_done``), the device-memory sampler's stop
(``obs.peak_hbm_bytes``) and the refresh gate (``stream.refresh_gate_*``).
"""

import numpy as np
import pytest

from fakepta_tpu.obs import telemetry as jtel
from fakepta_tpu.obs.metrics import EventLog as JEventLog
from fakepta_tpu_torch.obs import memwatch, telemetry
from fakepta_tpu_torch.obs.metrics import (ACCEPTED_SCHEMAS, SCHEMA_V2,
                                           EventLog)
from fakepta_tpu_torch.obs.telemetry import (AlertRules, TelemetryAggregator,
                                             TelemetryPublisher)


def _snap(seq, epoch="e1", t=None, p99=5.0, **extra):
    snap = {"seq": seq, "epoch": epoch,
            "t": float(t if t is not None else seq), "replica": "r0",
            "slo": {"serve_requests": seq * 2, "serve_failed": 0,
                    "serve_dispatches": seq, "qps_per_chip": 0.5,
                    "p50_ms": 1.0, "p99_ms": p99, "queue_depth": 0}}
    snap.update(extra)
    return snap


def _both(**kw):
    """(JAX aggregator, port aggregator) built alike."""
    rules = kw.pop("rules", None)
    if rules is not None:
        kw_j = dict(kw, alert_rules=jtel.AlertRules(**rules))
        kw_t = dict(kw, alert_rules=AlertRules(**rules))
    else:
        kw_j, kw_t = kw, kw
    return jtel.TelemetryAggregator(**kw_j), TelemetryAggregator(**kw_t)


def _ingest(pair, *args, **kw):
    got = [agg.ingest(*args, **kw) for agg in pair]
    assert got[0] == got[1]
    return got[1]


def _same_rollup(pair):
    want, got = (agg.rollup() for agg in pair)
    assert got == want
    assert (pair[1].ingested, pair[1].dropped_stale) == (
        pair[0].ingested, pair[0].dropped_stale)
    return got


def test_knobs_and_schema_equal_jax():
    from fakepta_tpu.tune import defaults as jknobs
    from fakepta_tpu_torch.tune import defaults as knobs
    for name in ("TELEMETRY_RING_SIZE", "TELEMETRY_WINDOW_S",
                 "ALERT_P99_SLO_MS",
                 "ALERT_HEARTBEAT_MISS_STREAK", "ALERT_APPEND_REGRESSION_X",
                 "ALERT_HBM_WATERMARK_FRAC", "DEFAULT_BYTES_BUDGET",
                 "STREAM_BLOCK_BUCKETS", "STREAM_GROWTH_RATIO",
                 "REFRESH_EVERY_APPENDS", "REFRESH_MIN_SNR_GAIN",
                 "FS_TOUCH_TOL", "FS_LANE_BINS"):
        assert getattr(knobs, name) == getattr(jknobs, name), name
    assert telemetry.SCHEMA == jtel.SCHEMA == SCHEMA_V2


def test_publisher_ring_live_gauges_and_failing_source():
    telemetry.clear_live_gauges()
    jtel.clear_live_gauges()
    try:
        snaps = []
        for mod in (jtel, telemetry):
            pub = mod.TelemetryPublisher("r0", ring_size=4)
            pub.add_source("slo", lambda: {"serve_requests": 7})
            pub.add_source("broken", lambda: 1 / 0)
            mod.publish("obs.peak_hbm_bytes", 123.0)
            s = pub.snapshot()
            for _ in range(6):
                pub.snapshot()
            snaps.append((s, [r["seq"] for r in pub.ring()]))
        (js, jring), (s, ring) = snaps
        drop = ("epoch", "t")
        assert ({k: v for k, v in s.items() if k not in drop}
                == {k: v for k, v in js.items() if k not in drop})
        assert ring == jring == [4, 5, 6, 7]
        assert s["seq"] == 1 and s["replica"] == "r0"
        assert s["slo"] == {"serve_requests": 7}
        # a failing source is skipped, never propagated: the good sources
        # and live gauges still land in the same snapshot
        assert "broken" not in s
        assert s["live"]["obs.peak_hbm_bytes"] == 123.0
        # a restarted publisher gets a fresh seq epoch
        assert TelemetryPublisher("r0").epoch != \
            TelemetryPublisher("r0").epoch
    finally:
        telemetry.clear_live_gauges()
        jtel.clear_live_gauges()


def test_aggregator_watermark_drops_stale_and_resets_on_epoch():
    pair = _both(window_s=60.0, ring_size=8)
    assert _ingest(pair, "r0", _snap(1)) is True
    assert _ingest(pair, "r0", _snap(2)) is True
    # duplicate / reordered scrape: at-or-below watermark is dropped
    assert _ingest(pair, "r0", _snap(2)) is False
    assert _ingest(pair, "r0", _snap(1)) is False
    assert pair[1].dropped_stale == 2 and pair[1].ingested == 2
    row = _same_rollup(pair)["per_replica"]["r0"]
    assert row["snapshots"] == 2 and row["seq"] == 2
    assert row["qps"] == pytest.approx(2.0)
    # restarted publisher: fresh epoch resets watermark + ring
    assert _ingest(pair, "r0", _snap(1, epoch="e2")) is True
    row = _same_rollup(pair)["per_replica"]["r0"]
    assert row["snapshots"] == 1 and row["seq"] == 1


def test_aggregator_retire_freezes_rollup_until_rejoin():
    pair = _both(window_s=60.0, ring_size=8)
    _ingest(pair, "r0", _snap(1))
    _ingest(pair, "r0", _snap(2))
    for agg in pair:
        agg.retire("r0")
    rollup = _same_rollup(pair)
    assert "r0" not in rollup["per_replica"]
    assert rollup["retired"]["r0"]["snapshots"] == 2
    # a re-join supersedes the frozen rollup
    assert _ingest(pair, "r0", _snap(1, epoch="e2")) is True
    rollup = _same_rollup(pair)
    assert "r0" in rollup["per_replica"] and not rollup["retired"]


def test_rollup_rows_for_pools_streams_and_live_gauges():
    """The rollup's optional rows (warm pool, streams, live gauges and the
    append-latency regression inputs) equal JAX's over a window."""
    pair = _both(window_s=60.0, ring_size=8)
    for seq, ms in ((1, 1.0), (2, 1.2), (3, 4.0), (4, 5.0)):
        _ingest(pair, "r0", _snap(
            seq, pool={"entries": 2, "max_entries": 8, "builds": 1,
                       "specs": {"abc123": {"warm_buckets": 3}}},
            streams={"s0": {"appends": seq, "append_mean_ms": ms}},
            live={"obs.peak_hbm_bytes": 9.0, "sample.segments_done": seq}),
            health={"state": "healthy", "misses": 0,
                    "breaker_open": False})
    row = _same_rollup(pair)["per_replica"]["r0"]
    assert row["warm_entries"] == 2 and row["peak_hbm_bytes"] == 9.0
    assert row["append_baseline_ms"] == pytest.approx(1.1)
    assert row["append_recent_ms"] == pytest.approx(4.5)
    assert row["health"] == "healthy"


def test_rollup_event_log_round_trip(tmp_path):
    pair = _both(rules=dict(p99_slo_ms=1.0))    # every ingest breaches
    _ingest(pair, "r0", _snap(1, p99=50.0))
    _ingest(pair, "r1", _snap(1, p99=50.0, t=1.5))
    path = tmp_path / "telemetry.jsonl"
    pair[1].save(path, meta={"replica_id": "router"})
    jpath = tmp_path / "jax.jsonl"
    pair[0].save(jpath, meta={"replica_id": "router"})
    log = EventLog.load(path)
    assert log.schema == SCHEMA_V2
    assert [ln for ln in log.lines if ln["kind"] != "summary"] == [
        ln for ln in JEventLog.load(jpath).lines if ln["kind"] != "summary"]
    kinds = [line["kind"] for line in log.lines]
    assert kinds.count("telemetry") == 2 and "alert" in kinds
    # the summary fast-path carries the full rollup, and either package
    # reads the other's file
    rollup = telemetry.rollup_from_event_log(log)
    assert rollup == jtel.rollup_from_event_log(JEventLog.load(path))
    assert set(rollup["per_replica"]) == {"r0", "r1"}
    assert any(a["rule"] == "p99_over_slo" for a in rollup["alerts"])
    # strip the summary: the rebuild path re-aggregates the raw lines
    # through the same watermark logic
    bare = tmp_path / "bare.jsonl"
    bare.write_text(pair[1].to_event_log().to_jsonl())
    rebuilt = telemetry.rollup_from_event_log(EventLog.load(bare))
    assert rebuilt == jtel.rollup_from_event_log(JEventLog.load(bare))
    assert set(rebuilt["per_replica"]) == {"r0", "r1"}


def test_event_log_rejects_unknown_schema():
    assert SCHEMA_V2 in ACCEPTED_SCHEMAS
    with pytest.raises(ValueError, match="unknown event-log schema"):
        EventLog(schema="fakepta_tpu.obs/99")
    header = '{"kind": "header", "schema": "fakepta_tpu.obs/99", "meta": {}}'
    with pytest.raises(ValueError, match="refusing to mix"):
        EventLog.parse(header + "\n")


def test_alert_rules_fire_once_per_excursion_and_rearm():
    rules = [mod.AlertRules(p99_slo_ms=100.0, miss_streak=3)
             for mod in (jtel, telemetry)]
    breach = {"per_replica": {"r0": {"replica": "r0", "p99_ms": 250.0,
                                     "t": 1.0}}}
    clear = {"per_replica": {"r0": {"replica": "r0", "p99_ms": 10.0,
                                    "t": 2.0}}}

    def step(rollup):
        got = [r.evaluate(rollup) for r in rules]
        assert got[1] == got[0]
        assert rules[1].active() == rules[0].active()
        return got[1]

    fired = step(breach)
    assert [a["rule"] for a in fired] == ["p99_over_slo"]
    assert fired[0]["p99_ms"] == 250.0 and fired[0]["slo_ms"] == 100.0
    # edge-triggered: a sustained breach fires exactly once
    assert step(breach) == []
    assert [a["rule"] for a in rules[1].active()] == ["p99_over_slo"]
    # the condition clearing re-arms the rule...
    assert step(clear) == [] and rules[1].active() == []
    # ...so the next excursion fires again, as a new log entry
    assert len(step(breach)) == 1
    assert list(rules[1].log) == list(rules[0].log) and len(rules[1].log) == 2


@pytest.mark.parametrize("row,kw,expect", [
    ({"replica": "m", "heartbeat_misses": 3, "t": 0.0},
     dict(miss_streak=3), "heartbeat_miss_streak"),
    ({"replica": "g", "append_baseline_ms": 1.0, "append_recent_ms": 5.0,
      "t": 0.0}, dict(regression_x=2.0), "append_latency_regression"),
    ({"replica": "h", "peak_hbm_bytes": 60.0, "t": 0.0},
     dict(hbm_frac=0.5, hbm_budget_bytes=100.0), "hbm_watermark"),
    ({"replica": "q", "p99_ms": 50.0, "heartbeat_misses": 2,
      "append_baseline_ms": 1.0, "append_recent_ms": 2.0,
      "peak_hbm_bytes": 50.0, "t": 0.0},
     dict(p99_slo_ms=100.0, miss_streak=3, regression_x=3.0, hbm_frac=0.9,
          hbm_budget_bytes=100.0), None),
], ids=["miss", "regress", "hbm", "quiet"])
def test_alert_rules_cover_all_four_conditions(row, kw, expect):
    """Each rule over a row built to trip it (and an under-threshold twin
    that stays quiet) fires as JAX's does."""
    rollup = {"per_replica": {row["replica"]: row}}
    fired = AlertRules(**kw).evaluate(rollup)
    assert fired == jtel.AlertRules(**kw).evaluate(rollup)
    assert [a["rule"] for a in fired] == ([expect] if expect else [])


def test_memwatch_stop_publishes_the_peak(monkeypatch):
    """The device-memory sampler's stop publishes its peak as the live
    ``obs.peak_hbm_bytes`` gauge (a host mesh reports nothing, so the
    allocator read is stubbed here; the card test reads a real one)."""
    telemetry.clear_live_gauges()
    try:
        sampler = memwatch.HbmSampler(["cpu"])
        assert sampler.stop() == {}
        assert "obs.peak_hbm_bytes" not in telemetry.live_gauges()
        monkeypatch.setattr(memwatch, "local_device_stats", lambda devs: {
            "bytes_in_use": 5, "peak_bytes_in_use": 77, "bytes_limit": 99})
        assert sampler.stop()["peak_bytes_in_use"] == 77
        assert telemetry.live_gauges()["obs.peak_hbm_bytes"] == 77
    finally:
        telemetry.clear_live_gauges()


def test_sampler_and_refresh_gate_publish():
    """A sampler run publishes ``sample.segments_done`` per drained
    segment; the refresh gate publishes its holds and opens."""
    from fakepta_tpu_torch.batch import PulsarBatch
    from fakepta_tpu_torch.infer import (ComponentSpec, FreeParam,
                                         LikelihoodSpec)
    from fakepta_tpu_torch.sample import SampleSpec, SamplingRun
    from fakepta_tpu_torch.stream import (PosteriorRefresher, RefreshPolicy,
                                          default_stream_model)

    telemetry.clear_live_gauges()
    try:
        batch = PulsarBatch.synthetic(npsr=2, ntoa=16, n_red=2, n_dm=2,
                                      device="cpu")
        model = LikelihoodSpec(components=(ComponentSpec(
            "curn", nbin=2, spectrum="free_spectrum", free=(
                FreeParam("log10_rho", (-9.0, -5.0), per_bin=True),)),))
        SamplingRun(batch, SampleSpec(model=model, n_chains=2, warmup=0),
                    device="cpu").run(6, segment=2)
        assert telemetry.live_gauges()["sample.segments_done"] == 3

        class Stream:
            model = default_stream_model()
            appends = 0

            def stats(self):
                return {}

        class Counting(PosteriorRefresher):
            def refresh(self, n_steps=200, seed=0, **kw):
                self.refreshes += 1
                self._mark_appends = int(self.stream.appends)
                return {}

        stream = Stream()
        ref = Counting(stream, policy=RefreshPolicy(every_appends=1))
        ref.maybe_refresh()
        assert telemetry.live_gauges()["stream.refresh_gate_holds"] == 1
        stream.appends = 1
        ref.maybe_refresh()
        assert telemetry.live_gauges()["stream.refresh_gate_opens"] == 1
    finally:
        telemetry.clear_live_gauges()
