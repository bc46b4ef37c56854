"""Run-timeline export as Chrome trace-event JSON (port of
``fakepta_tpu.obs.trace``; Perfetto-viewable).

A run's report carries its **timeline**: per-chunk span records
(run-relative ``t0`` / ``dur`` seconds plus a logical lane ``tid``) taken
on the dispatch thread, the pipeline's writer thread and, from the CUDA
events around each chunk, the device. This module converts those records,
straight from a :class:`.report.RunReport` artifact, to the Chrome
trace-event JSON format:

    python -m fakepta_tpu_torch.obs trace run.jsonl -o trace.json
    # open https://ui.perfetto.dev and load trace.json

Lanes (one track per ``tid``): ``main`` (dispatch spans, host staging,
depth-bound stalls, recycle instants), ``device`` (execute spans) and
``writer`` (drain spans with nested checkpoint appends). The run's stage
names (``obs.timing.span``) are instant markers on the device lane; per-op
device timing comes from ``torch.profiler``.

Multi-process runs write one event-log shard per rank
(``run(eventlog=dir)`` -> ``events-p<rank>.jsonl``); passing all shards
merges them into one trace with one **pid per rank**. Timestamps are
per-rank run-relative clocks; lanes align at run start.

Spans that carry a request ``trace_id`` in their args (``trace_ids`` on a
cohort span) are linked into one Chrome **flow** (``ph: "s"/"t"/"f"``)
across pid lanes. :func:`validate_trace` checks the format's invariants.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence

from .report import RunReport

# stable thread ids per logical lane (sort order = display order);
# lanes the serve layer adds ("serve", "router") are allocated past these
# per report, first-seen order
TID = {"main": 0, "device": 1, "writer": 2}

_VALID_PH = {"X", "i", "M"}
#: flow phases (start/step/finish) — trace-id links across pid lanes
_FLOW_PH = {"s", "t", "f"}


def timeline_events(report: RunReport, pid: Optional[int] = None) -> List[dict]:
    """Chrome trace events for one report's recorded timeline.

    ``pid`` defaults to the report's ``meta.process_index`` (0 when the run
    predates multi-host metadata) — one process lane per host shard.
    """
    meta = report.meta or {}
    if pid is None:
        pid = int(meta.get("process_index", 0))
    events: List[dict] = []

    label = (f"fakepta_tpu_torch run p{pid}"
             f" [{meta.get('statistic_path', '?')}"
             f", depth {meta.get('pipeline_depth', '?')}"
             f", {meta.get('platform', '?')}]")
    events.append({"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                   "args": {"name": label}})
    events.append({"ph": "M", "pid": pid, "tid": 0, "name": "process_sort_index",
                   "args": {"sort_index": pid}})
    # lane table: the three engine lanes plus any serve-layer lanes this
    # report's timeline introduces ("serve", "router"), in first-seen
    # order — unknown lanes get their own track instead of stacking on
    # the dispatch lane
    lanes: Dict[str, int] = dict(TID)
    for ev in report.timeline:
        lane = str(ev.get("tid", "main"))
        if lane not in lanes:
            lanes[lane] = max(lanes.values()) + 1
    for lane, tid in lanes.items():
        events.append({"ph": "M", "pid": pid, "tid": tid,
                       "name": "thread_name", "args": {"name": lane}})
        events.append({"ph": "M", "pid": pid, "tid": tid,
                       "name": "thread_sort_index",
                       "args": {"sort_index": tid}})

    first_exec_t0 = None
    for ev in report.timeline:
        tid = lanes[str(ev.get("tid", "main"))]
        name = str(ev.get("name", "?"))
        t0 = float(ev.get("t0", 0.0))
        args = {k: v for k, v in ev.items()
                if k not in ("name", "t0", "dur", "tid")}
        if ev.get("dur") is None:
            events.append({"ph": "i", "pid": pid, "tid": tid, "name": name,
                           "ts": t0 * 1e6, "s": "t", "args": args})
            continue
        if name == "execute" and first_exec_t0 is None:
            first_exec_t0 = t0
        events.append({"ph": "X", "pid": pid, "tid": tid, "name": name,
                       "ts": t0 * 1e6, "dur": float(ev["dur"]) * 1e6,
                       "args": args})

    # the run's stage names, as instant markers on the device lane at the
    # first execute span (per-op timing is torch.profiler's job; these mark
    # WHAT the run contains)
    for span in report.spans:
        events.append({"ph": "i", "pid": pid, "tid": TID["device"],
                       "name": f"stage:{span}",
                       "ts": (first_exec_t0 or 0.0) * 1e6, "s": "t",
                       "args": {}})
    return events


def flow_events(events: Sequence[dict]) -> List[dict]:
    """Chrome flow events linking spans that share a request trace id.

    Scans built span events for ``args.trace_id`` (and each entry of a
    cohort span's ``args.trace_ids``), groups by trace id, and for every
    id carried by two or more spans emits an ``s``/``t``.../``f`` chain
    with a shared numeric flow ``id``, each link coincident with its
    anchor span's start (Perfetto binds a flow event to the enclosing
    slice on the same pid/tid). A failed-over request therefore draws one
    arrow through the router span, the dead replica's spans, and the
    surviving replica's spans.
    """
    groups: Dict[str, List[dict]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue    # flows bind to slices, not instants/metadata
        args = ev.get("args") or {}
        ids = []
        if args.get("trace_id"):
            ids.append(str(args["trace_id"]))
        ids.extend(str(t) for t in (args.get("trace_ids") or ()))
        for trace_id in ids:
            groups.setdefault(trace_id, []).append(ev)
    flows: List[dict] = []
    flow_id = 0
    for trace_id in sorted(groups):
        chain = sorted(groups[trace_id],
                       key=lambda e: (e["ts"], e["pid"], e["tid"]))
        if len(chain) < 2:
            continue    # nothing to link
        flow_id += 1
        last = len(chain) - 1
        for k, anchor in enumerate(chain):
            link = {"ph": "s" if k == 0 else "f" if k == last else "t",
                    "cat": "trace", "name": f"trace:{trace_id}",
                    "id": flow_id, "pid": anchor["pid"],
                    "tid": anchor["tid"], "ts": anchor["ts"]}
            if k == last:
                link["bp"] = "e"    # bind to the enclosing slice
            flows.append(link)
    return flows


def build_trace(reports: Sequence[RunReport]) -> dict:
    """One Chrome trace object merging the given reports (pid per shard).

    Shards sharing a ``process_index`` (or lacking one) are assigned
    distinct pids in input order, so merging N single-host artifacts never
    silently stacks their lanes. Spans sharing a request ``trace_id``
    across shards are joined by flow events (:func:`flow_events`).
    """
    events: List[dict] = []
    used_pids: set = set()
    for i, rep in enumerate(reports):
        pid = int((rep.meta or {}).get("process_index", i))
        while pid in used_pids:
            pid += 1
        used_pids.add(pid)
        events.extend(timeline_events(rep, pid=pid))
    flows = flow_events(events)
    events.extend(flows)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {"tool": "fakepta_tpu_torch.obs trace",
                     "shards": len(reports), "flows": len(flows)},
    }


def validate_trace(trace: dict) -> None:
    """Raise ValueError unless ``trace`` is valid Chrome trace-event JSON.

    Checks the format's structural invariants: a ``traceEvents`` list whose
    entries carry a known ``ph``, integer ``pid``/``tid``, numeric
    non-negative ``ts`` (and ``dur`` for complete events), string names,
    and JSON-serializable ``args``. Duration events must not claim negative
    time. This is what the tier-1 schema test pins.
    """
    if not isinstance(trace, dict) or not isinstance(
            trace.get("traceEvents"), list):
        raise ValueError("trace must be an object with a traceEvents list")
    for i, ev in enumerate(trace["traceEvents"]):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            raise ValueError(f"{where}: not an object")
        ph = ev.get("ph")
        if ph not in _VALID_PH and ph not in _FLOW_PH:
            raise ValueError(f"{where}: unknown ph {ph!r}")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise ValueError(f"{where}: missing name")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                raise ValueError(f"{where}: {key} must be an int")
        if ph == "M":
            if not isinstance(ev.get("args"), dict):
                raise ValueError(f"{where}: metadata event without args")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"{where}: ts must be a non-negative number")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"{where}: complete event needs dur >= 0")
        if ph in _FLOW_PH and not isinstance(ev.get("id"), (int, str)):
            raise ValueError(f"{where}: flow event needs an id")
    json.dumps(trace)   # everything must serialize


def load_reports(paths: Iterable) -> List[RunReport]:
    """Load report/event-log shards (any file RunReport.save wrote)."""
    return [RunReport.load(p) for p in paths]


def export(paths: Sequence, out_path) -> dict:
    """Load shards, build + validate the merged trace, write it; returns
    summary counts for the CLI."""
    reports = load_reports(paths)
    trace = build_trace(reports)
    validate_trace(trace)
    with open(out_path, "w") as fh:
        json.dump(trace, fh)
    spans = sum(1 for ev in trace["traceEvents"] if ev["ph"] == "X")
    pids = {ev["pid"] for ev in trace["traceEvents"]}
    return {"events": len(trace["traceEvents"]), "spans": spans,
            "processes": len(pids),
            "flows": int(trace["metadata"].get("flows", 0)),
            "path": str(out_path)}


def overlap_s(report: RunReport, a: str = "drain", b: str = "execute") -> float:
    """Total seconds where any ``a`` span overlaps any ``b`` span of a
    LATER chunk — the pipeline's measured concurrency (used by the tests'
    acceptance and handy interactively)."""
    spans_a = [ev for ev in report.timeline if ev.get("name") == a
               and ev.get("dur") is not None]
    spans_b = [ev for ev in report.timeline if ev.get("name") == b
               and ev.get("dur") is not None]
    total = 0.0
    for ea in spans_a:
        for eb in spans_b:
            if eb.get("chunk", -1) <= ea.get("chunk", -1):
                continue
            lo = max(float(ea["t0"]), float(eb["t0"]))
            hi = min(float(ea["t0"]) + float(ea["dur"]),
                     float(eb["t0"]) + float(eb["dur"]))
            total += max(hi - lo, 0.0)
    return total
