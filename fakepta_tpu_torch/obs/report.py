"""RunReport: the per-run telemetry artifact of the ensemble engine (port of
``fakepta_tpu.obs.report``).

Every ``EnsembleSimulator.run()`` returns one under ``out["report"]`` (and
as ``sim.last_report``): meta, stage spans, per-chunk records, the
compile/steady split, cost and device-memory fields, and the run
timeline. :meth:`RunReport.save` writes the JAX package's JSON-lines
layout (schema ``fakepta_tpu.obs/1``), so either package's
``RunReport.load`` reads the other's files, and ``summary()`` has the JAX
report's keys under the same names.

Two fields mean what they can on the card:

- ``compile_s`` is the seconds spent building CUDA kernels inside the run
  (``nvcc``, :mod:`..ops._build`): 0 when the kernels were already built
  or loaded. The JAX package times XLA compiles there.
- ``retraces`` is always 0: the port traces no programs.

The metric-direction tables are the JAX package's, unchanged, so a
comparison or a regression gate reads both packages' reports alike (the
JAX module's comments say why each name sits where it does).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from .metrics import Collector, EventLog

# exact names where bigger is better
HIGHER_IS_BETTER = {
    "append_speedup_x", "coalesce_factor", "ess_min", "fleet_qps",
    "fleet_qps_per_chip", "fleet_solo_qps", "fleet_speedup_x",
    "fs_refresh_speedup_x", "fs_speedup_x", "gw_device_s_saved",
    "intensity_flop_per_byte", "real_per_s", "serve_qps_per_chip",
    "serve_serial_qps_per_chip", "serve_speedup_x",
    "steady_real_per_s_per_chip", "tuned_real_per_s_per_chip",
    "tuned_speedup_x", "value", "vs_baseline"}
HIGHER_SUFFIXES = ("_per_s_per_chip", "_significance_sigma",
                   "_detection_rate", "_hit_rate", "_reduction_x")

# run-shape facts and distribution-scale diagnostics: moving is
# information, not a regression
EXEMPT_METRICS = {
    "accept_rate", "chunks", "config", "faults_recovered",
    "fleet_breaker_closes", "fleet_breakered", "fleet_drains",
    "fleet_joined_replica", "fleet_joins", "fleet_killed_replica",
    "fleet_kind", "fleet_probes", "fleet_replicas", "fleet_replicas_alive",
    "fleet_requests", "fleet_scrapes", "fleet_solo_p50_ms",
    "fleet_transport", "fleet_verified", "fleet_verified_failover",
    "fleet_wedge_state", "fleet_wedged", "fleet_wedged_replica",
    "fs_bins_touched", "fs_lane_count", "fs_lanes_touched", "gw_coalesced",
    "gw_requests", "gw_tenants", "gw_throttles", "gw_verified",
    "hbm_samples", "n_kept", "nreal", "packed_buffer_bytes",
    "packed_buffers_live_peak", "packed_depth_bound_bytes",
    "packed_ring_degraded", "pipeline_depth", "queue_depth",
    "scale_events", "serve_dispatches", "serve_kind", "serve_realizations",
    "serve_requests", "serve_verified", "serve_warm_s", "stream_appends",
    "stream_compiles", "stream_rebuckets", "stream_toas", "swap_rate",
    "trace_flows", "tune_probes", "tuned"}
EXEMPT_SUFFIXES = ("_amp2_mean", "_sigma_empirical", "_sigma_analytic",
                   "_null_q95", "_p_value_median", "_lnl_max_mean",
                   "_grid_k")

# non-numeric row-identity fields
ROW_IDENTITY = {"fallback", "metric", "platform", "scenario", "unit"}

# exact names where smaller is better: the default direction, listed so
# the direction contract is total
LOWER_IS_BETTER = {
    "append_latency_ms", "ckpt_wait_s", "compile_s",
    "cost_bytes_per_chunk", "cost_bytes_per_chunk_fused",
    "cost_bytes_per_chunk_fused_bf16", "cost_flops_per_chunk",
    "faults_degradations", "faults_retries", "faults_rollbacks",
    "fleet_alerts", "fleet_breaker_opens", "fleet_failovers",
    "fleet_heartbeat_misses", "fleet_join_steady_compiles",
    "fleet_lost_requests", "fleet_p50_ms", "fleet_p99_ms",
    "fleet_scrape_errors", "fleet_steady_compiles", "fleet_timeouts",
    "fs_full_refresh_ms", "fs_oracle_max_err", "fs_recompiles",
    "fs_refresh_ms", "fs_wall_s_critical", "fs_wall_s_total",
    "gw_cutover_ms", "gw_p99_ms_under_quota", "lnlike_bytes_per_chunk",
    "model_bytes_per_chunk", "model_bytes_per_chunk_fused",
    "model_bytes_per_chunk_fused_bf16", "os_bytes_per_chunk",
    "pad_waste_frac", "peak_hbm_bytes", "pipeline_stall_s", "restage_ms",
    "retraces", "rhat_max", "scn_append_p99_ms", "scn_peak_hbm_bytes",
    "serve_p50_ms", "serve_p99_ms", "serve_retraces",
    "serve_steady_compiles", "stream_recompiles",
    "telemetry_overhead_frac", "tune_probe_s"}


def metric_higher_is_better(k: str) -> bool:
    """True when a DROP in metric ``k`` is the regression direction."""
    return k in HIGHER_IS_BETTER or k.endswith(HIGHER_SUFFIXES)


def metric_exempt(k: str) -> bool:
    """True when metric ``k`` is informational (never a regression)."""
    return k in EXEMPT_METRICS or k.endswith(EXEMPT_SUFFIXES)


@dataclass
class RunReport:
    """Structured telemetry for one ``run()`` call."""

    meta: Dict = field(default_factory=dict)      # nreal/chunk/platform/mesh..
    spans: List[str] = field(default_factory=list)
    chunks: List[dict] = field(default_factory=list)   # {idx, wall_s, ...}
    counters: Dict[str, float] = field(default_factory=dict)
    gauges: Dict[str, float] = field(default_factory=dict)
    timings: Dict[str, List[float]] = field(default_factory=dict)
    retraces: int = 0
    compile_s: float = 0.0
    total_s: float = 0.0
    cost: Dict[str, float] = field(default_factory=dict)
    memory: Dict[str, float] = field(default_factory=dict)
    # run-relative span records of the dispatch, writer and device lanes
    # ({name, t0, dur, tid, chunk, ...}, seconds; dur None = instant)
    timeline: List[dict] = field(default_factory=list)

    # -- derived -----------------------------------------------------------
    @property
    def nchunks(self) -> int:
        return len(self.chunks)

    @property
    def first_chunk_s(self) -> float:
        return self.chunks[0]["wall_s"] if self.chunks else 0.0

    @property
    def steady_s(self) -> float:
        """Wall time excluding the first (build-bearing) chunk."""
        return max(self.total_s - self.first_chunk_s, 0.0)

    def real_per_s(self) -> float:
        n = self.meta.get("nreal", 0)
        return n / self.total_s if self.total_s > 0 else 0.0

    def steady_real_per_s(self) -> float:
        """Steady-state realizations/s: when the run built kernels, its
        first chunk is excluded (count and wall), or with one chunk the
        build time subtracted; otherwise the whole run is steady."""
        n = self.meta.get("nreal", 0)
        chunk = self.meta.get("chunk", n)
        if self.compile_s <= 0:
            return self.real_per_s()
        if self.nchunks > 1 and self.steady_s > 0:
            return (n - min(chunk, n)) / self.steady_s
        denom = self.total_s - self.compile_s
        return n / denom if denom > 0 else 0.0

    def steady_real_per_s_per_chip(self) -> float:
        return self.steady_real_per_s() / max(self.meta.get("n_devices", 1), 1)

    # -- summary metrics (the flat table `compare` diffs) ------------------
    def summary(self) -> Dict[str, float]:
        m = {
            "nreal": self.meta.get("nreal", 0),
            "chunks": self.nchunks,
            "retraces": self.retraces,
            "compile_s": round(self.compile_s, 6),
            "total_s": round(self.total_s, 6),
            "first_chunk_s": round(self.first_chunk_s, 6),
            "real_per_s": round(self.real_per_s(), 3),
            "steady_real_per_s_per_chip":
                round(self.steady_real_per_s_per_chip(), 3),
        }
        if self.cost.get("bytes_per_chunk"):
            m["cost_bytes_per_chunk"] = self.cost["bytes_per_chunk"]
        if self.cost.get("flops_per_chunk"):
            m["cost_flops_per_chunk"] = self.cost["flops_per_chunk"]
        if self.cost.get("model_bytes_per_chunk"):
            m["model_bytes_per_chunk"] = self.cost["model_bytes_per_chunk"]
        if self.cost.get("bytes_per_chunk") and \
                self.cost.get("flops_per_chunk"):
            m["intensity_flop_per_byte"] = round(
                self.cost["flops_per_chunk"] / self.cost["bytes_per_chunk"],
                3)
        if self.memory.get("peak_bytes_in_use"):
            m["peak_bytes_in_use"] = self.memory["peak_bytes_in_use"]
        if self.memory.get("peak_hbm_bytes"):
            m["peak_hbm_bytes"] = self.memory["peak_hbm_bytes"]
        if self.meta.get("pipeline_depth") is not None:
            # stall_s: host waits the dispatch loop took (the depth bound);
            # ckpt_wait_s: the checkpoint appends (on the writer thread when
            # pipelined, inside the chunk wall when serial)
            m["pipeline_depth"] = int(self.meta["pipeline_depth"])
            m["pipeline_stall_s"] = round(
                sum(c.get("stall_s", 0.0) for c in self.chunks), 6)
            m["ckpt_wait_s"] = round(
                sum(c.get("ckpt_wait_s", 0.0) for c in self.chunks), 6)
        # the detection lane's rate; the lnlike and tuned lanes below are
        # the JAX package's (the port's engine does not run them yet), kept
        # so a loaded JAX report summarizes alike
        if self.meta.get("os"):
            m["os_real_per_s_per_chip"] = round(
                self.steady_real_per_s_per_chip(), 3)
            if self.cost.get("bytes_per_chunk"):
                m["os_bytes_per_chunk"] = self.cost["bytes_per_chunk"]
        if self.meta.get("tuned"):
            m["tuned"] = 1
        if self.meta.get("lnlike"):
            k = int(self.meta["lnlike"].get("k", 1))
            m["lnlike_evals_per_s_per_chip"] = round(
                self.steady_real_per_s_per_chip() * k, 3)
            if self.cost.get("bytes_per_chunk"):
                m["lnlike_bytes_per_chunk"] = self.cost["bytes_per_chunk"]
        extra = self.meta.get("extra_metrics")
        if isinstance(extra, dict):
            m.update(extra)
        return m

    # -- construction ------------------------------------------------------
    @classmethod
    def from_collector(cls, collector: Collector, meta: dict,
                       **kwargs) -> "RunReport":
        rep = cls(meta=dict(meta), spans=list(collector.spans),
                  counters=dict(collector.counters),
                  gauges=dict(collector.gauges),
                  timings={k: list(v) for k, v in collector.timings.items()},
                  **kwargs)
        # the kernel builds this run paid for (ops/_build.py observes each)
        rep.compile_s = sum(rep.timings.get("kernels.build_s", []))
        return rep

    # -- serialization -----------------------------------------------------
    def to_json(self) -> dict:
        return {
            "meta": self.meta, "spans": self.spans, "chunks": self.chunks,
            "counters": self.counters, "gauges": self.gauges,
            "timings": self.timings, "timeline": self.timeline,
            "retraces": self.retraces,
            "compile_s": self.compile_s, "total_s": self.total_s,
            "cost": self.cost, "memory": self.memory,
            "summary": self.summary(),
        }

    def save(self, path) -> str:
        """Write the JSON-lines artifact (schema-framed; see module doc)."""
        log = EventLog(meta=self.meta)
        for name in self.spans:
            log.append("span", name=name)
        for c in self.chunks:
            log.append("chunk", **c)
        for ev in sorted(self.timeline, key=lambda e: e.get("t0", 0.0)):
            log.append("tl", **ev)
        for name, value in sorted(self.counters.items()):
            log.append("counter", name=name, value=value)
        for name, value in sorted(self.gauges.items()):
            log.append("gauge", name=name, value=value)
        for name, values in sorted(self.timings.items()):
            log.append("timing", name=name, values=values)
        log.append("report", retraces=self.retraces,
                   compile_s=self.compile_s, total_s=self.total_s,
                   cost=self.cost, memory=self.memory)
        return log.save(path, summary=self.summary())

    @classmethod
    def load(cls, path) -> "RunReport":
        log = EventLog.load(path)
        rep = cls(meta=log.meta)
        for line in log.lines:
            kind = line.get("kind")
            if kind == "span":
                rep.spans.append(line["name"])
            elif kind == "chunk":
                rep.chunks.append(
                    {k: v for k, v in line.items() if k != "kind"})
            elif kind == "counter":
                rep.counters[line["name"]] = line["value"]
            elif kind == "gauge":
                rep.gauges[line["name"]] = line["value"]
            elif kind == "timing":
                rep.timings[line["name"]] = list(line["values"])
            elif kind == "tl":
                rep.timeline.append(
                    {k: v for k, v in line.items() if k != "kind"})
            elif kind == "report":
                rep.retraces = int(line.get("retraces", 0))
                rep.compile_s = float(line.get("compile_s", 0.0))
                rep.total_s = float(line.get("total_s", 0.0))
                rep.cost = dict(line.get("cost", {}))
                rep.memory = dict(line.get("memory", {}))
        return rep

    def __repr__(self) -> str:   # compact, log-friendly
        return (f"RunReport(nreal={self.meta.get('nreal')}, "
                f"chunks={self.nchunks}, retraces={self.retraces}, "
                f"compile_s={self.compile_s:.3f}, total_s={self.total_s:.3f})")


def format_summary(rep: RunReport) -> str:
    """Human-readable one-report table."""
    rows = [("metric", "value")]
    for k, v in rep.summary().items():
        rows.append((k, f"{v:g}" if isinstance(v, float) else str(v)))
    rows.append(("spans", ",".join(rep.spans) or "-"))
    w = max(len(r[0]) for r in rows)
    return "\n".join(f"{k:<{w}}  {v}" for k, v in rows)


def format_delta(a: RunReport, b: RunReport,
                 rel_threshold: float = 0.10) -> tuple:
    """Per-metric delta table between two reports.

    Returns ``(text, regressions)``: the names that moved the wrong way by
    more than ``rel_threshold`` (throughput down; stalls, builds, bytes up).
    """
    ma, mb = a.summary(), b.summary()
    keys = sorted(set(ma) | set(mb))
    lines = [f"{'metric':<28} {'a':>14} {'b':>14} {'delta':>12}"]
    regressions = []

    def _num(v):
        return (float(v) if isinstance(v, (int, float))
                and not isinstance(v, bool) else None)

    for k in keys:
        va, vb = ma.get(k), mb.get(k)
        if _num(va) is None or _num(vb) is None:
            # missing on one side, or not a number: informational row
            lines.append(f"{k:<28} {va if va is not None else '-':>14} "
                         f"{vb if vb is not None else '-':>14} {'-':>12}")
            continue
        delta = vb - va
        rel = delta / abs(va) if va else (1.0 if delta else 0.0)
        flag = ""
        if not metric_exempt(k) and abs(rel) > rel_threshold:
            worse = rel < 0 if metric_higher_is_better(k) else rel > 0
            if worse:
                flag = "  << REGRESSION"
                regressions.append(k)
        lines.append(f"{k:<28} {va:>14g} {vb:>14g} {rel:>+11.1%}{flag}")
    return "\n".join(lines), regressions
