"""``obs top``: the telemetry rollup as a refreshing terminal table (port
of ``fakepta_tpu.obs.topview``, line for line).

Pure string rendering over a :meth:`..telemetry.TelemetryAggregator.rollup`
dict: the CLI (``obs/cli.py``) supplies the fetch (a live
``telemetry``-kind poll over the serve socket, or a saved
``fakepta_tpu.obs/2`` log) and the refresh loop lives here so tests can
drive it with a scripted fetch and zero sleeps.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, List, Optional

_COLUMNS = ("REPLICA", "HEALTH", "QPS", "P50ms", "P99ms", "QUEUE",
            "WARM", "HIT%", "BRKR", "MISS")


def _fmt(value, width: int) -> str:
    if isinstance(value, float):
        text = f"{value:.1f}"
    else:
        text = str(value)
    return text[:width].rjust(width)


def render_table(rollup: dict) -> str:
    """One frame: fleet header, per-replica rows, rollup detail lines."""
    fleet = rollup.get("fleet", {})
    lines: List[str] = []
    lines.append(
        f"fleet: {fleet.get('replicas', 0)} replicas  "
        f"qps={fleet.get('qps', 0.0):.1f}  "
        f"queue={fleet.get('queue_depth', 0)}  "
        f"p99max={fleet.get('p99_ms_max', 0.0):.1f}ms  "
        f"scrapes={fleet.get('ingested', 0)} "
        f"(stale={fleet.get('dropped_stale', 0)})")
    widths = (10, 8, 8, 8, 8, 6, 6, 6, 5, 5)
    lines.append("  ".join(c.rjust(w) for c, w in zip(_COLUMNS, widths)))
    for rid, row in sorted(rollup.get("per_replica", {}).items()):
        warm = (f"{row.get('warm_entries', 0)}/{row.get('warm_max', 0)}"
                if "warm_entries" in row else "-")
        cells = (
            rid, row.get("health", "?"), row.get("qps", 0.0),
            row.get("p50_ms", 0.0), row.get("p99_ms", 0.0),
            row.get("queue_depth", 0), warm,
            f"{100.0 * row.get('cache_hit_rate', 0.0):.0f}"
            if "cache_hit_rate" in row else "-",
            "open" if row.get("breaker_open") else "-",
            row.get("heartbeat_misses", 0))
        lines.append("  ".join(_fmt(c, w) for c, w in zip(cells, widths)))
        for spec, info in sorted(row.get("specs", {}).items()):
            lines.append(f"    spec {spec[:12]}: "
                         f"warm_buckets={info.get('warm_buckets', 0)}")
        for stream, info in sorted(row.get("streams", {}).items()):
            mean = info.get("append_mean_ms")
            lines.append(
                f"    stream {stream}: appends={info.get('appends', 0)}"
                + (f" mean={mean:.2f}ms" if mean is not None else ""))
        gates = {k: v for k, v in row.get("live", {}).items()
                 if k.startswith(("stream.refresh", "sample."))}
        for name, value in sorted(gates.items()):
            lines.append(f"    {name} = {value}")
    gw = rollup.get("gateway")
    if gw:
        lines.append(
            f"gateway: requests={gw.get('requests', 0)}  "
            f"hits={gw.get('hits', 0)} "
            f"({100.0 * gw.get('hit_rate', 0.0):.0f}%)  "
            f"coalesced={gw.get('coalesced', 0)}  "
            f"throttles={gw.get('throttles', 0)}  "
            f"saved={gw.get('device_s_saved', 0.0):.2f}s")
    tenants = rollup.get("tenants", {})
    if tenants:
        twidths = (10, 8, 8, 6, 6, 6, 8)
        lines.append("  ".join(c.rjust(w) for c, w in zip(
            ("TENANT", "QPS", "REQS", "429s", "HIT%", "SHARE", "P99ms"),
            twidths)))
        for tid, row in sorted(tenants.items()):
            cells = (
                tid, row.get("qps", 0.0), row.get("requests", 0),
                row.get("throttles", 0),
                f"{100.0 * row.get('hit_rate', 0.0):.0f}",
                f"{100.0 * row.get('queue_share', 0.0):.0f}%",
                row.get("p99_ms", 0.0))
            lines.append("  ".join(_fmt(c, w)
                                   for c, w in zip(cells, twidths)))
    for rid in sorted(rollup.get("retired", {})):
        lines.append(f"  retired: {rid}")
    for alert in rollup.get("alerts", []):
        lines.append(f"  ALERT {alert.get('rule')} on "
                     f"{alert.get('replica')}: "
                     + ", ".join(f"{k}={v}" for k, v in sorted(
                         alert.items()) if k not in ("rule", "replica")))
    return "\n".join(lines) + "\n"


def run_top(fetch: Callable[[], dict], interval_s: float = 1.0,
            iterations: Optional[int] = None, out=None) -> int:
    """The refresh loop: fetch → render → clear-and-redraw.

    ``iterations=None`` runs until the fetch raises KeyboardInterrupt /
    EOFError (the live terminal case); tests pass a finite count and a
    StringIO ``out``. Returns the number of frames rendered.
    """
    out = out if out is not None else sys.stdout
    frames = 0
    while iterations is None or frames < iterations:
        try:
            rollup = fetch()
        except (KeyboardInterrupt, EOFError):
            break
        if frames and out.isatty():           # pragma: no cover - terminal
            out.write("\x1b[2J\x1b[H")
        out.write(render_table(rollup))
        out.flush()
        frames += 1
        if iterations is not None and frames >= iterations:
            break
        time.sleep(interval_s)
    return frames
