"""Live telemetry plane (port of ``fakepta_tpu.obs.telemetry``).

Three pieces, replica to fleet:

- :class:`TelemetryPublisher`: per replica. Snapshots registered sources
  (pool SLO counters, warm-pool occupancy, stream append latencies, plus
  the process-wide :func:`publish` live gauges: sampler segment progress,
  refresh-gate decisions, ``obs.peak_hbm_bytes``) into a bounded ring. A
  snapshot is a plain JSON-able dict stamped with a per-publisher ``seq``
  and a monotonic ``t``, the watermark ingredients.
- :class:`TelemetryAggregator`: fleet level. Ingests snapshots keyed by
  replica id, keeps a windowed per-replica ring, and rolls it up keyed
  replica x spec-hash x stream-name. The merge is watermark-correct: a
  snapshot with ``seq`` at or below the replica's watermark is dropped
  (duplicates, reordered scrapes), a re-joining replica's fresh ``seq``
  epoch resets the baseline instead of producing negative rates, and a
  retired replica's last rollup is kept frozen under ``retired``.
- :class:`AlertRules`: threshold rules over the rollup (p99 over SLO,
  heartbeat-miss streak, append-latency regression, device-memory
  watermark). Edge-triggered: each rule fires one flight-recorder note
  when it trips and re-arms when the condition clears.

Everything here is host-side dict arithmetic: no torch, no sockets, the
JAX module line for line. Its publish sites in the port are the sampler's
segment drain (``sample.segments_done``), the device-memory sampler's
stop (``obs.peak_hbm_bytes``) and the stream refreshers
(``stream.refresh_gate_holds`` / ``_opens``, ``stream.fs_bins_touched``).
The wire (the serve protocol's ``telemetry`` and ``metrics`` kinds,
``ServePool.telemetry_rollup``), the scrape cadence (the health monitor's
heartbeat scrape, :mod:`..serve.health`) and the rollup's renderers
(:mod:`.promfmt`, :mod:`.topview`, the obs CLI's ``top`` and ``alerts``)
and the fleet that aggregates several replicas (:mod:`..serve.fleet`)
are ported.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, List, Optional

from ..tune import defaults as tune_defaults
from . import flightrec, metrics
from .timing import now

#: schema tag stamped on telemetry event-log lines (the ``telemetry`` and
#: ``alert`` record kinds ride the ``fakepta_tpu.obs/2`` era, the JAX
#: package's string)
SCHEMA = metrics.SCHEMA_V2


# --- process-wide live gauges ----------------------------------------------
# Lightweight cross-layer publishing: deep layers (sampler segment loop,
# refresh gate, memwatch) set a value; the publisher snapshots the table.
# One dict store under a lock per publish, cheap enough for append paths.

_live_lock = threading.Lock()
_live: Dict[str, float] = {}


def publish(name: str, value) -> None:
    """Set a live gauge the next telemetry snapshot will carry."""
    with _live_lock:
        _live[name] = value


def live_gauges() -> Dict[str, float]:
    """Snapshot of the process-wide live-gauge table."""
    with _live_lock:
        return dict(_live)


def clear_live_gauges() -> None:
    """Test hook: forget all live gauges (process-global state)."""
    with _live_lock:
        _live.clear()


class TelemetryPublisher:
    """Per-replica snapshot ring over registered sources.

    Sources are zero-arg callables returning JSON-able values; a failing
    source is recorded (``telemetry.scrape_errors``) and skipped, never
    propagated — telemetry is best-effort and must not take the serving
    path down with it.
    """

    def __init__(self, replica_id: str = "",
                 ring_size: int = tune_defaults.TELEMETRY_RING_SIZE):
        self.replica_id = str(replica_id)
        self._lock = threading.Lock()
        self._sources: Dict[str, Callable[[], object]] = {}
        self._ring = collections.deque(maxlen=int(ring_size))
        self._seq = 0
        #: seq epoch: lets an aggregator distinguish a restarted publisher
        #: (fresh counters) from a reordered scrape of the old one
        self.epoch = flightrec.spec_hash({"kind": "telemetry-epoch",
                                          "replica": self.replica_id,
                                          "nonce": id(self)})

    def add_source(self, name: str, fn: Callable[[], object]) -> None:
        with self._lock:
            self._sources[name] = fn

    def snapshot(self) -> dict:
        """Build one snapshot, append it to the ring, and return it."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            sources = list(self._sources.items())
        snap = {"seq": seq, "epoch": self.epoch, "t": now(),
                "replica": self.replica_id}
        for name, fn in sources:
            try:
                snap[name] = fn()
            except Exception as exc:   # noqa: BLE001 — recorded, not raised
                metrics.count("telemetry.scrape_errors")
                flightrec.note("telemetry_source_failed", source=name,
                               error=repr(exc)[:160])
        snap["live"] = live_gauges()
        metrics.count("telemetry.scrapes")
        with self._lock:
            self._ring.append(snap)
        return snap

    def ring(self) -> List[dict]:
        with self._lock:
            return list(self._ring)


class _ReplicaWindow:
    """One replica's snapshot window inside the aggregator."""

    __slots__ = ("ring", "watermark", "epoch", "health")

    def __init__(self, ring_size: int):
        self.ring = collections.deque(maxlen=ring_size)
        self.watermark = 0          # highest seq merged this epoch
        self.epoch = None
        self.health = {}            # last health-ladder info from the scraper


class TelemetryAggregator:
    """Fleet-level windowed rollups over scraped replica snapshots."""

    def __init__(self, window_s: float = tune_defaults.TELEMETRY_WINDOW_S,
                 ring_size: int = tune_defaults.TELEMETRY_RING_SIZE,
                 alert_rules: Optional["AlertRules"] = None):
        self.window_s = float(window_s)
        self.ring_size = int(ring_size)
        self._lock = threading.Lock()
        self._replicas: Dict[str, _ReplicaWindow] = {}
        self._retired: Dict[str, dict] = {}
        self.alerts = alert_rules if alert_rules is not None else AlertRules()
        self.ingested = 0
        self.dropped_stale = 0

    # -- ingestion (the heartbeat scraper's call) --------------------------
    def ingest(self, replica_id: str, snap: dict,
               health: Optional[dict] = None) -> bool:
        """Merge one scraped snapshot; returns whether it advanced the
        replica's watermark (False = stale duplicate, dropped)."""
        rid = str(replica_id)
        seq = int(snap.get("seq", 0))
        epoch = snap.get("epoch")
        with self._lock:
            win = self._replicas.get(rid)
            if win is None:
                win = self._replicas[rid] = _ReplicaWindow(self.ring_size)
                # a re-join after retire supersedes the frozen rollup
                self._retired.pop(rid, None)
            if epoch != win.epoch:
                # restarted publisher (new process / re-join): fresh seq
                # epoch, fresh baseline — never a negative-rate merge
                win.epoch = epoch
                win.watermark = 0
                win.ring.clear()
            if seq <= win.watermark:
                self.dropped_stale += 1
                return False
            win.watermark = seq
            win.ring.append(snap)
            if health is not None:
                win.health = dict(health)
            self.ingested += 1
        self.alerts.evaluate(self.rollup())
        return True

    def retire(self, replica_id: str) -> None:
        """Freeze a draining replica's last rollup (watermark-correct
        retirement: its history leaves the live window but is not lost)."""
        rid = str(replica_id)
        with self._lock:
            win = self._replicas.pop(rid, None)
        if win is not None and win.ring:
            self._retired[rid] = self._rollup_one(rid, win)

    # -- rollups -----------------------------------------------------------
    def _window(self, win: _ReplicaWindow) -> List[dict]:
        snaps = list(win.ring)
        if not snaps:
            return []
        horizon = snaps[-1].get("t", 0.0) - self.window_s
        return [s for s in snaps if s.get("t", 0.0) >= horizon]

    def _rollup_one(self, rid: str, win: _ReplicaWindow) -> dict:
        snaps = self._window(win)
        if not snaps:
            return {"replica": rid, "snapshots": 0}
        first, last = snaps[0], snaps[-1]
        slo0, slo1 = first.get("slo", {}), last.get("slo", {})

        def _slo(key, default=0.0):
            # the pool's slo_summary prefixes its metric names (the bench
            # schema's ``serve_*`` family); bare names are the fallback so
            # hand-rolled publishers stay ingestible
            return slo1.get("serve_" + key, slo1.get(key, default))

        dt = max(last.get("t", 0.0) - first.get("t", 0.0), 1e-9)
        dreq = (slo1.get("serve_requests", 0)
                - slo0.get("serve_requests", 0))
        row = {
            "replica": rid,
            "snapshots": len(snaps),
            "seq": last.get("seq", 0),
            "t": last.get("t", 0.0),
            "health": win.health.get("state", "unknown"),
            "heartbeat_misses": win.health.get("misses", 0),
            "breaker_open": bool(win.health.get("breaker_open", False)),
            # window qps: counter delta over the window's monotonic span
            # (one snapshot = no delta yet, report the pool's own figure)
            "qps": (dreq / dt if len(snaps) > 1
                    else _slo("qps_per_chip")),
            "p50_ms": _slo("p50_ms"),
            "p99_ms": _slo("p99_ms"),
            "queue_depth": slo1.get("queue_depth", 0),
            "requests": slo1.get("serve_requests", 0),
            "failed": slo1.get("serve_failed", 0),
        }
        pool = last.get("pool", {})
        if pool:
            entries = pool.get("entries", 0)
            row["warm_entries"] = entries
            row["warm_max"] = pool.get("max_entries", 0)
            builds = pool.get("builds", 0)
            # cache hit rate: fraction of warm lookups that did not build
            hits = max(slo1.get("serve_dispatches", 0) - builds, 0)
            denom = max(slo1.get("serve_dispatches", 0), 1)
            row["cache_hit_rate"] = hits / denom
            row["specs"] = pool.get("specs", {})
        streams = last.get("streams", {})
        if streams:
            row["streams"] = streams
        live = last.get("live", {})
        if live:
            row["live"] = {k: v for k, v in sorted(live.items())}
            if "obs.peak_hbm_bytes" in live:
                row["peak_hbm_bytes"] = live["obs.peak_hbm_bytes"]
        # append-latency regression input: window baseline vs latest
        lat = [s.get("streams", {}) for s in snaps]
        base = [v.get("append_mean_ms") for d in lat[:max(len(lat) // 2, 1)]
                for v in d.values() if v.get("append_mean_ms")]
        tail = [v.get("append_mean_ms") for d in lat[len(lat) // 2:]
                for v in d.values() if v.get("append_mean_ms")]
        if base and tail:
            row["append_baseline_ms"] = sum(base) / len(base)
            row["append_recent_ms"] = sum(tail) / len(tail)
        return row

    def rollup(self) -> dict:
        """The fleet view: per-replica rows plus fleet totals, ready for
        ``obs top``, the Prometheus exposition, and the alert rules."""
        with self._lock:
            rows = {rid: self._rollup_one(rid, win)
                    for rid, win in self._replicas.items()}
            retired = dict(self._retired)
            counts = {"ingested": self.ingested,
                      "dropped_stale": self.dropped_stale}
        fleet = {
            "replicas": len(rows),
            "qps": sum(r.get("qps", 0.0) for r in rows.values()),
            "queue_depth": sum(r.get("queue_depth", 0)
                               for r in rows.values()),
            "p99_ms_max": max([r.get("p99_ms", 0.0)
                               for r in rows.values()] or [0.0]),
        }
        return {"schema": SCHEMA, "fleet": dict(fleet, **counts),
                "per_replica": rows, "retired": retired,
                "alerts": self.alerts.active()}

    # -- persistence (the obs/2 event-log surface) -------------------------
    def to_event_log(self, meta: Optional[dict] = None):
        """Serialize the live window as a ``fakepta_tpu.obs/2`` event log:
        one ``telemetry`` line per snapshot (oldest first), one ``alert``
        line per firing, plus a rollup summary."""
        log = metrics.EventLog(meta=dict(meta or {}, telemetry=True),
                               schema=SCHEMA)
        with self._lock:
            items = sorted(
                ((s.get("t", 0.0), rid, s)
                 for rid, win in self._replicas.items() for s in win.ring),
                key=lambda it: (it[0], it[1]))
        for t, rid, snap in items:
            # t is lifted to the line level so interleaving tools (`obs
            # summarize` over many artifacts) can sort without opening snaps
            log.append("telemetry", t=t, replica=rid, snap=snap)
        for alert in self.alerts.log:
            log.append("alert", **alert)
        return log

    def save(self, path, meta: Optional[dict] = None) -> str:
        return self.to_event_log(meta).save(
            path, summary={"rollup": self.rollup()})


def rollup_from_event_log(log) -> dict:
    """Rebuild a rollup from a saved obs/2 telemetry log (the file-fed
    path of ``obs top`` / ``obs alerts``)."""
    summary = log.summary() or {}
    if "rollup" in summary:
        return summary["rollup"]
    agg = TelemetryAggregator()
    for line in log.lines:
        if line.get("kind") == "telemetry":
            agg.ingest(line.get("replica", ""), line.get("snap", {}))
    return agg.rollup()


class AlertRules:
    """Threshold alert rules over an aggregator rollup (edge-triggered).

    Rules (docs/OBSERVABILITY.md "Alert rules", the JAX package's):

    - ``p99_over_slo``: a replica's windowed p99 exceeds the SLO bound;
    - ``heartbeat_miss_streak``: consecutive probe misses at/over the
      streak threshold (the pre-breaker early warning);
    - ``append_latency_regression``: the window's recent mean append
      latency exceeds ``regression_x`` times the window baseline;
    - ``hbm_watermark``: ``peak_hbm_bytes`` crosses the watermark
      fraction of the per-device budget.

    Each (rule, replica) pair fires ONE flight-recorder note per
    excursion and re-arms when the condition clears — alerting on every
    scrape of a sustained breach would bury the flight recorder's bounded
    ring in duplicates.
    """

    def __init__(self,
                 p99_slo_ms: float = tune_defaults.ALERT_P99_SLO_MS,
                 miss_streak: int =
                 tune_defaults.ALERT_HEARTBEAT_MISS_STREAK,
                 regression_x: float =
                 tune_defaults.ALERT_APPEND_REGRESSION_X,
                 hbm_frac: float = tune_defaults.ALERT_HBM_WATERMARK_FRAC,
                 hbm_budget_bytes: float =
                 tune_defaults.DEFAULT_BYTES_BUDGET):
        self.p99_slo_ms = float(p99_slo_ms)
        self.miss_streak = int(miss_streak)
        self.regression_x = float(regression_x)
        self.hbm_frac = float(hbm_frac)
        self.hbm_budget_bytes = float(hbm_budget_bytes)
        self._lock = threading.Lock()
        self._firing: Dict[tuple, dict] = {}
        #: full firing history (bounded like the publisher rings)
        self.log = collections.deque(
            maxlen=tune_defaults.TELEMETRY_RING_SIZE)

    def _conditions(self, row: dict):
        rid = row.get("replica", "")
        p99 = row.get("p99_ms", 0.0)
        if p99 > self.p99_slo_ms:
            yield ("p99_over_slo", rid,
                   {"p99_ms": p99, "slo_ms": self.p99_slo_ms})
        misses = row.get("heartbeat_misses", 0)
        if misses >= self.miss_streak:
            yield ("heartbeat_miss_streak", rid,
                   {"misses": misses, "streak": self.miss_streak})
        base = row.get("append_baseline_ms")
        recent = row.get("append_recent_ms")
        if base and recent and recent > self.regression_x * base:
            yield ("append_latency_regression", rid,
                   {"baseline_ms": base, "recent_ms": recent,
                    "regression_x": self.regression_x})
        hbm = row.get("peak_hbm_bytes")
        if hbm and hbm > self.hbm_frac * self.hbm_budget_bytes:
            yield ("hbm_watermark", rid,
                   {"peak_hbm_bytes": hbm,
                    "watermark_bytes": self.hbm_frac
                     * self.hbm_budget_bytes})

    def evaluate(self, rollup: dict) -> List[dict]:
        """Run every rule over the rollup; returns newly-fired alerts."""
        fired = []
        seen = set()
        for row in rollup.get("per_replica", {}).values():
            for rule, rid, detail in self._conditions(row):
                key = (rule, rid)
                seen.add(key)
                with self._lock:
                    if key in self._firing:
                        continue
                    alert = dict(detail, rule=rule, replica=rid,
                                 t=row.get("t", 0.0))
                    self._firing[key] = alert
                    self.log.append(alert)
                fired.append(alert)
                metrics.count("telemetry.alerts")
                flightrec.note("telemetry_alert", rule=rule, replica=rid,
                               **{k: v for k, v in detail.items()})
        with self._lock:   # re-arm rules whose condition cleared
            for key in [k for k in self._firing if k not in seen]:
                del self._firing[key]
        return fired

    def active(self) -> List[dict]:
        with self._lock:
            return [dict(a) for a in self._firing.values()]
