"""CLI: ``python -m fakepta_tpu_torch.obs summarize|compare|trace`` (port
of ``fakepta_tpu.obs.cli``).

``summarize`` prints one report's metric table (flight-recorder dumps get
a crash banner: spec hash, error, chunks completed); given SEVERAL paths
(or a directory) it interleaves every file's timestamped events into one
table with a per-replica column (the post-mortem view of several ranks'
or replicas' artifacts); ``compare`` prints a per-metric delta table
between two reports and flags regressions (throughput down; stalls,
builds, bytes up beyond the relative threshold); ``trace`` exports one or
more report / event-log shards as Chrome trace-event JSON for Perfetto
(a multi-process run's shards merge into one trace with a pid lane per
rank, request trace ids drawn as flows).

Not ported yet (ROADMAP Queue 1 item 11b): ``gate``, ``top`` and
``alerts``, which land with ``gate.py``, ``topview.py`` and
``promfmt.py``. ``compare`` exits 0 by default even with regressions
flagged; pass ``--fail-on-regression`` to gate on them. Exit 2 on usage
or I/O errors.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import List

from .metrics import EventLog
from .report import RunReport, format_delta, format_summary


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m fakepta_tpu_torch.obs",
        description="inspect, diff and trace ensemble-engine RunReport "
                    "artifacts (JSON-lines files written by report.save()); "
                    "gate, top and alerts are not ported yet (ROADMAP "
                    "Queue 1 item 11b)")
    sub = parser.add_subparsers(dest="command", required=True)

    summ = sub.add_parser("summarize", help="print one report's metrics, "
                                            "or interleave several")
    summ.add_argument("report", nargs="+",
                      help="RunReport .jsonl file(s) or flightrec-*.json "
                           "crash dump(s); several paths (or a directory "
                           "of them) interleave by timestamp with a "
                           "per-replica column")
    summ.add_argument("--format", choices=("text", "json"), default="text")

    comp = sub.add_parser("compare",
                          help="per-metric delta table between two reports")
    comp.add_argument("report_a", help="baseline RunReport .jsonl")
    comp.add_argument("report_b", help="candidate RunReport .jsonl")
    comp.add_argument("--rel-threshold", type=float, default=0.10,
                      help="relative change beyond which a metric moving the "
                           "wrong way is flagged (default 0.10)")
    comp.add_argument("--fail-on-regression", action="store_true",
                      help="exit 1 when any metric is flagged")

    tr = sub.add_parser(
        "trace", help="export the run timeline as Chrome trace-event JSON "
                      "(load the output at ui.perfetto.dev)")
    tr.add_argument("reports", nargs="+",
                    help="RunReport/event-log .jsonl file(s); pass every "
                         "per-rank shard of a multi-process run to merge "
                         "them into one trace with a pid lane per rank")
    tr.add_argument("-o", "--output", default="trace.json",
                    help="output path (default trace.json)")
    return parser


def _expand_report_paths(paths) -> List[str]:
    """CLI paths -> concrete files: a directory expands to every .json /
    .jsonl it holds (sorted)."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(str(f) for f in sorted(Path(p).iterdir())
                       if f.suffix in (".json", ".jsonl"))
        else:
            out.append(str(p))
    if not out:
        raise ValueError("no report files found")
    return out


def _interleave_rows(paths: List[str]) -> List[dict]:
    """Timestamped event rows from several artifacts, merged: each file's
    flight-recorder events (``t_mono_s``), timeline spans (``t0``) and
    telemetry / alert lines (``t``), tagged ``meta.replica_id``, else
    ``p<process_index>``, else the file stem."""
    rows: List[dict] = []
    for path in paths:
        log = EventLog.load(path)
        meta = log.meta or {}
        replica = str(meta.get("replica_id")
                      or (f"p{meta['process_index']}"
                          if "process_index" in meta else Path(path).stem))
        for line in log.lines:
            kind = line.get("kind")
            t = None
            if kind == "event":
                t, name = line.get("t_mono_s"), line.get("name", "?")
                detail = line.get("attrs") or {}
            elif kind == "tl":
                t, name = line.get("t0"), line.get("name", "?")
                detail = {k: v for k, v in line.items()
                          if k not in ("kind", "name", "t0")}
            elif kind in ("telemetry", "alert"):
                t, name = line.get("t"), kind
                detail = {k: v for k, v in line.items()
                          if k not in ("kind", "t")}
            if t is None:
                continue
            rows.append({"t": float(t), "replica": replica, "name": name,
                         "detail": detail})
    rows.sort(key=lambda r: (r["t"], r["replica"]))
    return rows


def _summarize_many(paths: List[str], fmt: str) -> int:
    rows = _interleave_rows(paths)
    if fmt == "json":
        print(json.dumps({"files": len(paths), "events": rows}, indent=2))
        return 0
    print(f"{len(paths)} artifact(s), {len(rows)} timestamped event(s)")
    print(f"{'t_s':>12}  {'replica':<14} {'event':<32} detail")
    for r in rows:
        detail = ", ".join(
            f"{k}={v}" for k, v in sorted(r["detail"].items())
            if not isinstance(v, (dict, list)))[:120]
        print(f"{r['t']:>12.6f}  {r['replica']:<14} {r['name']:<32} "
              f"{detail}")
    return 0


def _cmd_summarize(args) -> int:
    paths = _expand_report_paths(args.report)
    if len(paths) > 1:
        return _summarize_many(paths, args.format)
    rep = RunReport.load(paths[0])
    if args.format == "json":
        print(json.dumps(rep.to_json(), indent=2))
        return 0
    if rep.meta.get("flightrec"):
        # a crash dump: lead with WHICH configuration died and why
        print(f"FLIGHT RECORDER dump (crashed run)\n"
              f"  spec_hash : {rep.meta.get('spec_hash', '?')}\n"
              f"  crashed   : {rep.meta.get('crash_time', '?')}\n"
              f"  error     : {rep.meta.get('error') or '<none recorded>'}\n"
              f"  mesh      : {rep.meta.get('mesh_shape', '?')}  "
              f"chunks completed: {len(rep.chunks)}")
    print(format_summary(rep))
    return 0


def _cmd_trace(args) -> int:
    from .trace import export as trace_export

    info = trace_export(args.reports, args.output)
    print(f"wrote {info['path']}: {info['events']} events "
          f"({info['spans']} spans, {info['processes']} process lane(s)); "
          f"load it at https://ui.perfetto.dev")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.command == "summarize":
            return _cmd_summarize(args)
        if args.command == "trace":
            return _cmd_trace(args)
        rep_a = RunReport.load(args.report_a)
        rep_b = RunReport.load(args.report_b)
    except (OSError, ValueError, KeyError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    text, regressions = format_delta(rep_a, rep_b,
                                     rel_threshold=args.rel_threshold)
    print(text)
    if regressions:
        print(f"{len(regressions)} regression(s): {', '.join(regressions)}")
        if args.fail_on_regression:
            return 1
    else:
        print("no regressions flagged")
    return 0


if __name__ == "__main__":                               # pragma: no cover
    sys.exit(main())
