"""CLI: ``python -m fakepta_tpu_torch.analysis check <paths...>``.

Exit codes: 0 clean, 1 findings, 2 usage error — so the tier-1 test (and
any CI job) can gate on it directly. ``--write-baseline`` snapshots the
current findings into the committed baseline; the intended steady state is
an *empty* baseline with every sanctioned exception pragma'd in place,
because a pragma carries its justification next to the code and a baseline
entry does not.

``--format json`` emits the stable machine schema (CI annotations,
editors)::

    {"schema": "fakepta_tpu_torch.analysis/1",
     "count": 2,
     "findings": [{"path": ..., "line": ..., "col": ...,
                   "rule": ..., "message": ...}, ...]}

Findings are sorted (path, line, col, rule); the exit code is the same as
text mode. ``graph <paths...> --dot`` prints the whole-program lock-order
graph in DOT (cycle edges red) for docs and deadlock review.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import engine
from .rules import PROJECT_RULE_IDS, RULE_IDS

#: bump only with a documented migration; consumers pin on this
JSON_SCHEMA = "fakepta_tpu_torch.analysis/1"

DEFAULT_BASELINE = Path(__file__).parent / "baseline.json"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m fakepta_tpu_torch.analysis",
        description="AST linter for the port's correctness invariants "
                    "(clock/queue/cache discipline, metric names, lock "
                    "order, blocking under locks)")
    sub = parser.add_subparsers(dest="command", required=True)
    check = sub.add_parser("check", help="analyze files/directories")
    check.add_argument("paths", nargs="+",
                       help="python files or directories to analyze")
    check.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE,
                       help="baseline JSON of accepted findings "
                            "(default: the committed package baseline)")
    check.add_argument("--no-baseline", action="store_true",
                       help="report every finding, baseline ignored")
    check.add_argument("--write-baseline", action="store_true",
                       help="snapshot current findings into --baseline and "
                            "exit 0")
    check.add_argument("--format", choices=("text", "json"), default="text")
    check.add_argument("--root", type=Path, default=None,
                       help="directory paths are reported relative to "
                            "(default: cwd; baseline keys use these paths)")
    sub.add_parser("rules", help="list registered rule ids")
    graph = sub.add_parser(
        "graph", help="export the whole-program lock-order graph")
    graph.add_argument("paths", nargs="+",
                       help="python files or directories to index")
    graph.add_argument("--dot", action="store_true",
                       help="emit graphviz DOT (default: edge list)")
    graph.add_argument("--root", type=Path, default=None)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "rules":
        for rid in (RULE_IDS + PROJECT_RULE_IDS
                    + (engine.PRAGMA_RULE, engine.UNUSED_PRAGMA_RULE)):
            print(rid)
        return 0
    if args.command == "graph":
        from .concurrency import LockModel

        index = engine.build_project_index(args.paths, root=args.root)
        model = LockModel.of(index)
        if args.dot:
            sys.stdout.write(model.to_dot())
        else:
            for e in model.edges:
                via = f" via {e.via}" if e.via else ""
                print(f"{e.src} -> {e.dst}  [{e.module}:{e.line}{via}]")
        return 0

    findings = engine.check_paths(args.paths, root=args.root)
    if args.write_baseline:
        engine.save_baseline(args.baseline, findings)
        print(f"wrote {len(findings)} finding(s) to {args.baseline}")
        return 0
    if not args.no_baseline and args.baseline.exists():
        findings = engine.apply_baseline(
            findings, engine.load_baseline(args.baseline))

    if args.format == "json":
        print(json.dumps(
            {"schema": JSON_SCHEMA, "count": len(findings),
             "findings": [{"path": f.path, "line": f.line, "col": f.col,
                           "rule": f.rule, "message": f.message}
                          for f in findings]}, indent=2))
    else:
        for f in findings:
            print(f.format())
        n = len(findings)
        print(f"{n} finding(s)" if n else "clean: 0 findings")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
