"""Prometheus text-format exposition of a telemetry rollup (port of
``fakepta_tpu.obs.promfmt``, line for line).

The ``metrics`` protocol kind (``serve/cli.py``) and
``ServePool.metrics_text()`` render through here. Metric names are a
DECLARED schema (the table below, the JAX package's, documented in
docs/OBSERVABILITY.md "Prometheus metric names"): scrape configs and
dashboards depend on them, so renaming one is a schema change made here,
never inline. Everything is stdlib string formatting: no client library,
version 0.0.4 text format (``text/plain``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

#: the exposition schema: metric name -> (type, help). One row per exported
#: family; ``render`` refuses names outside this table so the exposition
#: can never drift from the documented schema.
PROM_METRICS: Dict[str, Tuple[str, str]] = {
    "fakepta_up":
        ("gauge", "1 when the replica's health ladder says healthy"),
    "fakepta_serve_qps":
        ("gauge", "windowed completed requests/s per replica"),
    "fakepta_serve_p50_ms":
        ("gauge", "request latency p50 (milliseconds)"),
    "fakepta_serve_p99_ms":
        ("gauge", "request latency p99 (milliseconds)"),
    "fakepta_serve_queue_depth":
        ("gauge", "pending requests in the scheduler queue"),
    "fakepta_serve_requests_total":
        ("counter", "requests admitted since replica start"),
    "fakepta_serve_failed_total":
        ("counter", "requests failed since replica start"),
    "fakepta_pool_warm_entries":
        ("gauge", "resident warm-pool spec entries"),
    "fakepta_pool_warm_max":
        ("gauge", "warm-pool LRU capacity"),
    "fakepta_pool_cache_hit_rate":
        ("gauge", "fraction of dispatches served without a pool build"),
    "fakepta_heartbeat_misses":
        ("gauge", "consecutive heartbeat probe misses"),
    "fakepta_breaker_open":
        ("gauge", "1 when the replica's routing breaker is open"),
    "fakepta_peak_hbm_bytes":
        ("gauge", "peak device-memory watermark (bytes)"),
    "fakepta_stream_appends_total":
        ("counter", "TOA blocks appended to the stream"),
    "fakepta_stream_append_mean_ms":
        ("gauge", "mean stream append latency (milliseconds)"),
    "fakepta_spec_warm_buckets":
        ("gauge", "prewarmed (lane, bucket) executables for the spec"),
    "fakepta_live_gauge":
        ("gauge", "process live gauges (sampler segment progress, "
                  "refresh-gate decisions, ...) keyed by name"),
    "fakepta_fleet_replicas":
        ("gauge", "live replicas in the aggregator window"),
    "fakepta_fleet_qps":
        ("gauge", "fleet-wide windowed requests/s"),
    "fakepta_fleet_queue_depth":
        ("gauge", "fleet-wide pending requests"),
    "fakepta_fleet_p99_ms_max":
        ("gauge", "worst per-replica p99 (milliseconds)"),
    "fakepta_alert_active":
        ("gauge", "1 per currently-firing alert rule"),
    "fakepta_gateway_tenant_qps":
        ("gauge", "windowed completed requests/s per tenant"),
    "fakepta_gateway_tenant_requests_total":
        ("counter", "requests admitted to the gateway per tenant"),
    "fakepta_gateway_tenant_throttles_total":
        ("counter", "429s (quota/fair-share rejections) per tenant"),
    "fakepta_gateway_tenant_hit_rate":
        ("gauge", "fraction of a tenant's requests served from the "
                  "result store"),
    "fakepta_gateway_tenant_queue_share":
        ("gauge", "a tenant's share of the gateway's in-flight slots"),
    "fakepta_gateway_cache_hits_total":
        ("counter", "requests served from the content-addressed store"),
    "fakepta_gateway_cache_rejects_total":
        ("counter", "store entries refused on integrity grounds "
                    "(CRC/schema/fingerprint mismatch)"),
    "fakepta_gateway_coalesced_total":
        ("counter", "requests folded into an in-flight identical leader"),
    "fakepta_gateway_device_seconds_saved":
        ("gauge", "device-seconds not spent thanks to cache hits"),
    "fakepta_gateway_cutovers_total":
        ("counter", "frozen-grid migration cutovers completed"),
}


def _escape(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _sample(out: List[str], name: str, labels: Dict[str, str],
            value) -> None:
    if name not in PROM_METRICS:
        raise ValueError(f"metric {name!r} is not in the declared "
                         f"PROM_METRICS schema (docs/OBSERVABILITY.md)")
    if labels:
        lab = ",".join(f'{k}="{_escape(v)}"'
                       for k, v in sorted(labels.items()))
        out.append(f"{name}{{{lab}}} {float(value):g}")
    else:
        out.append(f"{name} {float(value):g}")


def render(rollup: dict) -> str:
    """Render an aggregator rollup as Prometheus text exposition."""
    samples: List[str] = []
    used: List[str] = []

    def emit(name, labels, value):
        if name not in used:
            used.append(name)
        _sample(samples, name, labels, value)

    fleet = rollup.get("fleet", {})
    emit("fakepta_fleet_replicas", {}, fleet.get("replicas", 0))
    emit("fakepta_fleet_qps", {}, fleet.get("qps", 0.0))
    emit("fakepta_fleet_queue_depth", {}, fleet.get("queue_depth", 0))
    emit("fakepta_fleet_p99_ms_max", {}, fleet.get("p99_ms_max", 0.0))

    for rid, row in sorted(rollup.get("per_replica", {}).items()):
        lab = {"replica": rid}
        emit("fakepta_up", lab,
             1.0 if row.get("health") == "healthy" else 0.0)
        emit("fakepta_serve_qps", lab, row.get("qps", 0.0))
        emit("fakepta_serve_p50_ms", lab, row.get("p50_ms", 0.0))
        emit("fakepta_serve_p99_ms", lab, row.get("p99_ms", 0.0))
        emit("fakepta_serve_queue_depth", lab, row.get("queue_depth", 0))
        emit("fakepta_serve_requests_total", lab, row.get("requests", 0))
        emit("fakepta_serve_failed_total", lab, row.get("failed", 0))
        emit("fakepta_heartbeat_misses", lab,
             row.get("heartbeat_misses", 0))
        emit("fakepta_breaker_open", lab,
             1.0 if row.get("breaker_open") else 0.0)
        if "warm_entries" in row:
            emit("fakepta_pool_warm_entries", lab, row["warm_entries"])
            emit("fakepta_pool_warm_max", lab, row.get("warm_max", 0))
            emit("fakepta_pool_cache_hit_rate", lab,
                 row.get("cache_hit_rate", 0.0))
        if "peak_hbm_bytes" in row:
            emit("fakepta_peak_hbm_bytes", lab, row["peak_hbm_bytes"])
        for spec, info in sorted(row.get("specs", {}).items()):
            emit("fakepta_spec_warm_buckets", dict(lab, spec=spec),
                 info.get("warm_buckets", 0))
        for stream, info in sorted(row.get("streams", {}).items()):
            slab = dict(lab, stream=stream)
            emit("fakepta_stream_appends_total", slab,
                 info.get("appends", 0))
            if info.get("append_mean_ms") is not None:
                emit("fakepta_stream_append_mean_ms", slab,
                     info["append_mean_ms"])
        for name, value in sorted(row.get("live", {}).items()):
            if isinstance(value, (int, float)) and not isinstance(
                    value, bool):
                emit("fakepta_live_gauge", dict(lab, name=name), value)

    gw = rollup.get("gateway")
    if gw:
        emit("fakepta_gateway_cache_hits_total", {}, gw.get("hits", 0))
        emit("fakepta_gateway_cache_rejects_total", {},
             gw.get("cache_rejects", 0))
        emit("fakepta_gateway_coalesced_total", {}, gw.get("coalesced", 0))
        emit("fakepta_gateway_device_seconds_saved", {},
             gw.get("device_s_saved", 0.0))
        emit("fakepta_gateway_cutovers_total", {}, gw.get("cutovers", 0))
    for tid, row in sorted(rollup.get("tenants", {}).items()):
        lab = {"tenant": tid}
        emit("fakepta_gateway_tenant_qps", lab, row.get("qps", 0.0))
        emit("fakepta_gateway_tenant_requests_total", lab,
             row.get("requests", 0))
        emit("fakepta_gateway_tenant_throttles_total", lab,
             row.get("throttles", 0))
        emit("fakepta_gateway_tenant_hit_rate", lab,
             row.get("hit_rate", 0.0))
        emit("fakepta_gateway_tenant_queue_share", lab,
             row.get("queue_share", 0.0))

    for alert in rollup.get("alerts", []):
        emit("fakepta_alert_active",
             {"rule": alert.get("rule", ""),
              "replica": alert.get("replica", "")}, 1.0)

    out: List[str] = []
    for name in used:
        mtype, help_ = PROM_METRICS[name]
        out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} {mtype}")
        out.extend(s for s in samples
                   if s.split("{", 1)[0].split(" ", 1)[0] == name)
    return "\n".join(out) + ("\n" if out else "")
