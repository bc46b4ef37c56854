"""CLI: ``python -m fakepta_tpu_torch.infer run ...``.

Runs a CURN amplitude-slope recovery study on a synthetic array through the
device lnlike lane (:class:`~fakepta_tpu_torch.infer.InferenceRun`), on the
card unless ``--device cpu`` is given, prints one JSON summary line and
optionally saves the artifact (a loadable
:class:`~fakepta_tpu_torch.obs.report.RunReport`). The flags and defaults
are the JAX package's CLI's, with ``--device`` (default ``cuda``) in place
of its ``--platform``. Exit 0 on success, 2 on a usage or configuration
error.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m fakepta_tpu_torch.infer",
        description="on-device GP-marginalized PTA likelihood grids "
                    "(Woodbury lnL per realization) over synthetic "
                    "ensembles")
    sub = parser.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="run a CURN grid recovery study")
    run.add_argument("--npsr", type=int, default=16)
    run.add_argument("--ntoa", type=int, default=128)
    run.add_argument("--nreal", type=int, default=500)
    run.add_argument("--chunk", type=int, default=250)
    run.add_argument("--log10-A", type=float, default=-13.2,
                     help="injected CURN amplitude (the grid truth)")
    run.add_argument("--gamma", type=float, default=13 / 3,
                     help="injected CURN slope (the grid truth)")
    run.add_argument("--grid", type=int, nargs=2, default=[5, 5],
                     metavar=("NA", "NG"),
                     help="grid points over (log10_A, gamma)")
    run.add_argument("--bounds-log10-A", type=float, nargs=2,
                     default=[-13.8, -12.6])
    run.add_argument("--bounds-gamma", type=float, nargs=2,
                     default=[2.0, 6.0])
    run.add_argument("--mode", choices=["lnlike", "grad", "fisher"],
                     default="lnlike")
    run.add_argument("--seed", type=int, default=1)
    run.add_argument("--device", default="cuda",
                     help="torch device to run on (default cuda; cpu runs "
                          "the kernels' plain versions)")
    run.add_argument("--out", default=None,
                     help="save the summary artifact (JSON-lines) here")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import numpy as np

    from .. import spectrum as spectrum_lib
    from ..batch import PulsarBatch
    from ..device import resolve_device
    from ..parallel.montecarlo import GWBConfig
    from .model import ComponentSpec, FreeParam, LikelihoodSpec
    from .run import InferenceRun

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    try:
        # quiet per-pulsar noise so the CURN truth dominates the grid
        batch = PulsarBatch.synthetic(npsr=args.npsr, ntoa=args.ntoa,
                                      tspan_years=15.0, toaerr=1e-7,
                                      n_red=10, n_dm=10, red_log10_A=-14.5,
                                      dm_log10_A=-14.5, seed=0,
                                      device=device)
        f = np.arange(1, 11) / float(batch.tspan_common)
        psd = np.asarray(spectrum_lib.powerlaw(f, log10_A=args.log10_A,
                                               gamma=args.gamma))
        model = LikelihoodSpec(components=(
            ComponentSpec(target="red", spectrum="batch"),
            ComponentSpec(target="dm", spectrum="batch"),
            ComponentSpec(target="curn", nbin=10, free=(
                FreeParam("log10_A", tuple(args.bounds_log10_A)),
                FreeParam("gamma", tuple(args.bounds_gamma)))),
        ))
        study = InferenceRun(
            batch, model, gwb=GWBConfig(psd=psd, orf="curn"),
            grid_shape=tuple(args.grid),
            truth=(args.log10_A, args.gamma), mode=args.mode,
            device=device)
        out = study.run(args.nreal, seed=args.seed, chunk=args.chunk)
    except (ValueError, TypeError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    row = {"npsr": args.npsr, "nreal": args.nreal,
           "log10_A": args.log10_A, "gamma": args.gamma,
           "grid": list(args.grid), "mode": args.mode, **out["summary"]}
    if args.out:
        row["artifact"] = study.save(args.out)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":                               # pragma: no cover
    sys.exit(main())
