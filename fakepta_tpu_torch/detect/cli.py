"""CLI: ``python -m fakepta_tpu_torch.detect run ...``.

Runs a null-calibrated detection study on a synthetic array through the
device OS lane (:class:`~fakepta_tpu_torch.detect.DetectionRun`), on the
card unless ``--device cpu`` is given, prints one JSON summary line and
optionally saves the artifact (a loadable
:class:`~fakepta_tpu_torch.obs.report.RunReport`). The flags and defaults
are the JAX package's CLI's, with ``--device`` (default ``cuda``) in place
of its ``--platform``. As the JAX CLI meshes every device on the
realization axis, the study runs on a mesh of every visible card
(``--device cuda``; a numbered card such as ``cuda:1`` alone) or of the
one CPU device (``--device cpu``). Exit 0 on success, 2 on a usage or
configuration error.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m fakepta_tpu_torch.detect",
        description="on-device detection statistics (optimal statistic with "
                    "paired null calibration) over synthetic PTA ensembles")
    sub = parser.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="run a null-calibrated detection study")
    run.add_argument("--npsr", type=int, default=40)
    run.add_argument("--ntoa", type=int, default=260)
    run.add_argument("--nreal", type=int, default=2000)
    run.add_argument("--chunk", type=int, default=1000)
    run.add_argument("--log10-A", type=float, default=-14.0,
                     help="injected GWB amplitude (gamma fixed at 13/3)")
    run.add_argument("--orf", nargs="+", default=["hd"],
                     choices=["hd", "monopole", "dipole"],
                     help="ORF template lane(s) to compute")
    run.add_argument("--weighting", choices=["noise", "none"],
                     default="noise")
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
    import torch

    from .. import spectrum as spectrum_lib
    from ..batch import PulsarBatch
    from ..device import resolve_device
    from ..parallel.mesh import make_mesh
    from ..parallel.montecarlo import GWBConfig
    from .operators import OSSpec
    from .run import DetectionRun

    try:
        device = resolve_device(args.device)
        # every card on the realization axis, as the JAX CLI's
        # make_mesh(jax.devices())
        mesh = make_mesh(
            [f"cuda:{i}" for i in range(torch.cuda.device_count())]
            if device.type == "cuda" and device.index is None
            else [device])
    except (RuntimeError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    try:
        batch = PulsarBatch.synthetic(npsr=args.npsr, ntoa=args.ntoa,
                                      tspan_years=15.0, toaerr=1e-7,
                                      n_red=30, n_dm=30, seed=0,
                                      device=device)
        f = np.arange(1, 31) / float(batch.tspan_common)
        psd = np.asarray(spectrum_lib.powerlaw(f, log10_A=args.log10_A,
                                               gamma=13 / 3))
        study = DetectionRun(
            batch, gwb=GWBConfig(psd=psd, orf="hd"),
            os=OSSpec(orf=tuple(args.orf), weighting=args.weighting,
                      null=True),
            mesh=mesh)
        out = study.run(args.nreal, seed=args.seed, chunk=args.chunk)
    except (ValueError, TypeError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    row = {"npsr": args.npsr, "nreal": args.nreal,
           "log10_A": args.log10_A, "orfs": list(args.orf),
           "weighting": args.weighting, **out["summary"]}
    if args.out:
        row["artifact"] = study.save(args.out)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":                               # pragma: no cover
    sys.exit(main())
