"""CLI: ``python -m fakepta_tpu_torch.tune search|show|apply ...`` (port of
``fakepta_tpu.tune.cli``).

``search`` tunes the dispatch knobs for a synthetic-array spec (the
:class:`..serve.ArraySpec` surface), persists the
:class:`..tune.TunedConfig` and optionally writes the ``fakepta_tpu.tune/1``
artifact (``--out``; ``python -m fakepta_tpu_torch.obs summarize`` reads
it). ``show`` prints the store. ``apply`` resolves the knobs a tuned run
would pick on these devices and prints them as one JSON line, the
scriptable form of ``run(tuned=True)``. ``--device cpu`` stands in for the
JAX CLI's ``--platform cpu``; without it the CLI tunes every visible card.

Exit 0 on success, 1 when ``apply`` / ``show`` find nothing, 2 on usage
or configuration errors (no GPU without ``--device cpu`` among them).
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m fakepta_tpu_torch.tune",
        description="platform-aware autotuner for the engine dispatch "
                    "surface")
    sub = parser.add_subparsers(dest="command", required=True)

    def add_spec_args(p):
        p.add_argument("--npsr", type=int, default=20)
        p.add_argument("--ntoa", type=int, default=156)
        p.add_argument("--n-red", type=int, default=10)
        p.add_argument("--n-dm", type=int, default=10)
        p.add_argument("--gwb-ncomp", type=int, default=10)
        p.add_argument("--data-seed", type=int, default=0)
        p.add_argument("--device", default=None,
                       help="torch device to tune on (default: every "
                            "visible card; cpu runs on the host)")

    search = sub.add_parser(
        "search", help="model-first search + measured probes; persists "
                       "the winning knobs per platform fingerprint")
    add_spec_args(search)
    search.add_argument("--nreal-hint", type=int, default=4096,
                        help="workload scale the knobs will serve (caps "
                             "the chunk ladder)")
    search.add_argument("--budget-s", type=float, default=None,
                        help="probe wall-clock budget (default: "
                             "tune.defaults.PROBE_BUDGET_S)")
    search.add_argument("--probe-chunks", type=int, default=None,
                        help="measured chunks per probe (default: "
                             "tune.defaults.PROBE_CHUNKS)")
    search.add_argument("--max-candidates", type=int, default=12,
                        help="frontier size cap (model-ranked; the "
                             "hand-set default candidate always rides)")
    search.add_argument("--force", action="store_true",
                        help="re-probe even with a warm store entry")
    search.add_argument("--store", default=None,
                        help="store file path (default: "
                             "$FAKEPTA_TPU_TUNE_DIR/tuned.json, else "
                             "~/.cache/fakepta_tpu_torch/tuned.json)")
    search.add_argument("--out", default=None,
                        help="write the fakepta_tpu.tune/1 artifact here")

    show = sub.add_parser("show", help="print the TunedConfig store")
    show.add_argument("--store", default=None)

    apply_p = sub.add_parser(
        "apply", help="resolve + print the knobs a tuned run would pick "
                      "on these devices (one JSON line)")
    add_spec_args(apply_p)
    apply_p.add_argument("--store", default=None)
    return parser


def _spec(args):
    from ..serve.spec import ArraySpec
    return ArraySpec(npsr=args.npsr, ntoa=args.ntoa, n_red=args.n_red,
                     n_dm=args.n_dm, gwb_ncomp=args.gwb_ncomp,
                     data_seed=args.data_seed)


def _devices(args):
    return None if args.device is None else [args.device]


def _cmd_search(args) -> int:
    from .defaults import PROBE_CHUNKS
    from .search import search

    cfg, info = search(
        spec=_spec(args), mesh_devices=_devices(args),
        nreal_hint=args.nreal_hint, budget_s=args.budget_s,
        probe_chunks=(PROBE_CHUNKS if args.probe_chunks is None
                      else args.probe_chunks),
        max_candidates=args.max_candidates,
        store=args.store, force=args.force, artifact=args.out)
    line = {"tuned": 1, "warm": bool(info["warm"]),
            "tune_probes": int(info["probes"]),
            "tune_probe_s": round(float(info["probe_s"]), 3),
            "family": cfg.family, "knobs": cfg.knobs,
            "metrics": cfg.metrics}
    if info.get("store_path"):
        line["store"] = info["store_path"]
    print(json.dumps(line))
    return 0


def _cmd_show(args) -> int:
    from .store import TuneStore

    store = TuneStore(args.store)
    entries = store.load_entries()
    if store.path is None:
        print("no store configured (set FAKEPTA_TPU_TUNE_DIR or pass "
              "--store)", file=sys.stderr)
        return 1
    print(f"store: {store.path} ({len(entries)} entr"
          f"{'y' if len(entries) == 1 else 'ies'})")
    for key, raw in sorted(entries.items()):
        knobs = raw.get("knobs", {})
        metrics = raw.get("metrics", {})
        fp = raw.get("fingerprint", {})
        print(f"  {key}  platform={fp.get('platform')} "
              f"devices={fp.get('n_devices')} "
              f"knobs={json.dumps(knobs, sort_keys=True)} "
              f"rate={metrics.get('real_per_s_per_chip')}")
    return 0 if entries else 1


def _cmd_apply(args) -> int:
    from ..parallel.mesh import make_mesh
    from .search import resolve_for_sim

    sim = _spec(args).build(mesh=make_mesh(_devices(args)))
    cfg = resolve_for_sim(sim, store=args.store)
    if cfg is None:
        print("no tuned entry for this platform x spec family; run "
              "`python -m fakepta_tpu_torch.tune search` first",
              file=sys.stderr)
        return 1
    print(json.dumps({"family": cfg.family, "knobs": cfg.knobs,
                      "metrics": cfg.metrics, "created": cfg.created}))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.command == "search":
            return _cmd_search(args)
        if args.command == "show":
            return _cmd_show(args)
        if args.command == "apply":
            return _cmd_apply(args)
    except (OSError, ValueError, RuntimeError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    return 2


if __name__ == "__main__":                               # pragma: no cover
    sys.exit(main())
