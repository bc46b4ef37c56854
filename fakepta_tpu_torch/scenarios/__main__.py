"""Entry point: ``python -m fakepta_tpu_torch.scenarios list|describe|run``.

The JAX package's scenarios CLI, with ``--device`` (default ``cuda``):
``list`` prints the registry (name, scale, cadence, spec hash, analytic
cost estimate); ``describe NAME`` the full spec dict plus the reduced
CPU-stand-in shape; ``run NAME`` runs the golden-run harness
(:mod:`.golden`) on ``--device`` and prints the bench-schema row as one
JSON line: pipe it to a file and band it with ``python -m
fakepta_tpu_torch.obs gate``. ``run NAME --memory-lane`` runs the
psr-sharded memory-scaling sweep instead, on every visible card (a numbered
card such as ``cuda:1`` alone); it has no host stand-in, so ``--device
cpu`` is a usage error. Exit codes: 0 ok, 1 a contract violation under
``--check``, 2 usage errors (an unknown scenario, no card without
``--device cpu``, the memory lane off the card).
"""

from __future__ import annotations

import argparse
import json
import sys

from . import registry


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m fakepta_tpu_torch.scenarios",
        description="IPTA-scale scenario registry + golden-run suite")
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("list", help="print the registered scenarios")

    desc = sub.add_parser("describe", help="print one scenario's full "
                                           "spec, hash and cost estimate")
    desc.add_argument("name")

    run = sub.add_parser("run", help="golden-run one scenario; prints the "
                                     "bench-schema JSON row")
    run.add_argument("name")
    run.add_argument("--device", default="cuda",
                     help="torch device the lanes run on (default cuda; "
                          "cpu runs the kernels' plain versions on the "
                          "reduced spec)")
    run.add_argument("--out", default=None,
                     help="also write the row (one JSON line) here: the "
                          "artifact `obs gate` loads")
    run.add_argument("--report", default=None,
                     help="also save the ensemble lane's RunReport "
                          ".jsonl: the artifact `obs summarize|compare|"
                          "trace` load")
    run.add_argument("--full", action="store_true",
                     help="run the full-size spec even on the CPU "
                          "(default: reduced off the card)")
    run.add_argument("--nreal", type=int, default=64)
    run.add_argument("--chunk", type=int, default=32)
    run.add_argument("--sample-steps", type=int, default=96)
    run.add_argument("--serve-requests", type=int, default=32)
    run.add_argument("--skip", action="append", default=[],
                     choices=("sample", "serve", "stream"),
                     help="drop a lane (repeatable); the ensemble lane "
                          "always runs")
    run.add_argument("--memory-lane", action="store_true",
                     help="run the psr-sharded memory-scaling sweep "
                          "instead of the golden lanes (cards only)")
    run.add_argument("--check", action="store_true",
                     help="exit 1 when a contract (memory bound) fails "
                          "instead of just reporting")
    return parser


def _cmd_list() -> int:
    print(f"{'scenario':<14} {'npsr':>6} {'yrs':>5} {'cadence':<8} "
          f"{'hash':<12} {'model GB/chunk(1k)':>18}")
    for name in registry.names():
        s = registry.get(name)
        cost = s.est_cost(chunk=1024)
        print(f"{name:<14} {s.npsr:>6} {s.tspan_years:>5.0f} "
              f"{s.cadence:<8} {s.spec_hash():<12} "
              f"{cost['model_bytes_per_chunk'] / 1e9:>18.1f}")
    return 0


def _cmd_describe(name: str) -> int:
    s = registry.get(name)
    red = s.reduced()
    out = {
        "spec": s.spec_dict(),
        "spec_hash": s.spec_hash(),
        "est_cost": s.est_cost(chunk=1024),
        "reduced": {"npsr": red.npsr, "ntoa": red.ntoa,
                    "cadence_thin": red.cadence_thin,
                    "spec_hash": red.spec_hash()},
    }
    print(json.dumps(out, indent=2, default=str))
    return 0


def _lane_devices(device: str):
    """The memory lane's cards: every visible card for ``cuda``, a
    numbered card alone."""
    return None if device == "cuda" else [device]


def _cmd_run(args) -> int:
    from . import golden

    if args.memory_lane:
        try:
            lane = golden.memory_lane(args.name, chunk=args.chunk,
                                      devices=_lane_devices(args.device))
        except ValueError as exc:
            # a host device: the lane has nothing to measure there
            print(f"error: {exc}", file=sys.stderr)
            return 2
        print(json.dumps(lane, indent=2))
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(lane, fh, indent=2)
        if not lane["ok"]:
            print(f"memory lane: watermark/model ratio exceeded the "
                  f"declared bound {lane['bound_factor']}x",
                  file=sys.stderr)
            return 1 if args.check else 0
        return 0

    row = golden.golden_run(
        args.name, device=args.device,
        reduced=(False if args.full else None),
        nreal=args.nreal, chunk=args.chunk,
        sample_steps=args.sample_steps,
        serve_requests=args.serve_requests, skip=tuple(args.skip),
        report_path=args.report)
    print(json.dumps(row))
    if args.out:
        golden.save_row(row, args.out)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.command == "list":
            return _cmd_list()
        if args.command == "describe":
            return _cmd_describe(args.name)
        return _cmd_run(args)
    except KeyError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    except RuntimeError as exc:
        if "device='cpu'" not in str(exc):
            raise
        # no card and the CPU not asked for: a usage error
        print(f"error: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":                               # pragma: no cover
    sys.exit(main())
