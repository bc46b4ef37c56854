"""CLI: ``python -m fakepta_tpu_torch.sample run ...`` (port of
``fakepta_tpu.sample.cli``).

Samples a CURN posterior on a synthetic array through the on-device chain
lane (:class:`~fakepta_tpu_torch.sample.SamplingRun`), on the card unless
``--device cpu`` is given: a free-spectrum per-bin
``log10_rho`` model by default (the headline workload: its per-bin
conditional structure is embarrassingly parallel), or a (log10_A, gamma)
power law with ``--powerlaw``. Prints one JSON summary line (R-hat, ESS,
acceptance, throughput) and optionally saves the schema-versioned artifact
either package's ``RunReport.load`` reads. The flags are the JAX CLI's,
with ``--device`` (default ``cuda``) in place of ``--platform``. Exit 0 on
success, 2 on usage or configuration errors and without a GPU unless
``--device cpu`` (as the detect and infer CLIs).
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m fakepta_tpu_torch.sample",
        description="on-device batched MCMC posteriors (HMC x parallel "
                    "tempering, zero host round-trips in the chain loop) "
                    "over the Woodbury PTA likelihood")
    sub = parser.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="sample a CURN posterior")
    run.add_argument("--npsr", type=int, default=12)
    run.add_argument("--ntoa", type=int, default=96)
    run.add_argument("--nbin", type=int, default=6,
                     help="CURN frequency bins (free-spectrum dims)")
    run.add_argument("--powerlaw", action="store_true",
                     help="sample (log10_A, gamma) instead of per-bin "
                          "free-spectrum log10_rho")
    run.add_argument("--log10-A", type=float, default=None,
                     help="injected CURN amplitude (the data truth). "
                          "Defaults: -13.2 for --powerlaw, -14.5 for the "
                          "free spectrum — the projected per-bin truth "
                          "stays interior to the log10_rho box (truth "
                          "pinned at a prior edge piles posterior mass on "
                          "the boundary and costs divergences)")
    run.add_argument("--gamma", type=float, default=13 / 3,
                     help="injected CURN slope (the data truth)")
    run.add_argument("--chains", type=int, default=16)
    run.add_argument("--temps", type=int, default=2)
    run.add_argument("--steps", type=int, default=400,
                     help="post-warmup MCMC steps")
    run.add_argument("--warmup", type=int, default=200)
    run.add_argument("--thin", type=int, default=2)
    run.add_argument("--step-size", type=float, default=0.3)
    run.add_argument("--n-leapfrog", type=int, default=8)
    run.add_argument("--segment", type=int, default=None,
                     help="steps per jitted segment dispatch")
    run.add_argument("--seed", type=int, default=1)
    run.add_argument("--checkpoint", default=None)
    run.add_argument("--pipeline-depth", type=int, default=2)
    run.add_argument("--device", default="cuda",
                     help="torch device to run on (default cuda; cpu runs "
                          "on the host)")
    run.add_argument("--out", default=None,
                     help="save the summary artifact (JSON-lines) here")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import numpy as np

    from .. import spectrum as spectrum_lib
    from ..batch import PulsarBatch
    from ..device import resolve_device
    from ..infer import ComponentSpec, FreeParam, LikelihoodSpec
    from .model import SampleSpec
    from .run import SamplingRun

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    try:
        batch = PulsarBatch.synthetic(npsr=args.npsr, ntoa=args.ntoa,
                                      tspan_years=15.0, toaerr=1e-7,
                                      n_red=args.nbin, n_dm=args.nbin,
                                      red_log10_A=-14.5, dm_log10_A=-14.5,
                                      seed=0, device=device)
        if args.log10_A is None:
            args.log10_A = -13.2 if args.powerlaw else -14.5
        if args.powerlaw:
            curn = ComponentSpec(target="curn", nbin=args.nbin, free=(
                FreeParam("log10_A", (args.log10_A - 0.8,
                                      args.log10_A + 0.8)),
                FreeParam("gamma", (2.0, 6.0))))
            truth = np.array([args.log10_A, args.gamma])
        else:
            # the free-spectrum headline: one log10_rho slot per bin, the
            # truth projected from the injected power law on the array grid
            f = np.arange(1, args.nbin + 1) / float(batch.tspan_common)
            psd = spectrum_lib.evaluate_host(
                "powerlaw", f, log10_A=args.log10_A,
                gamma=args.gamma).astype(float)
            rho = 0.5 * np.log10(psd / float(batch.tspan_common))
            curn = ComponentSpec(target="curn", nbin=args.nbin,
                                 spectrum="free_spectrum", free=(
                                     FreeParam("log10_rho", (-9.0, -5.0),
                                               per_bin=True),))
            truth = np.clip(rho, -8.9, -5.1)
        model = LikelihoodSpec(components=(
            ComponentSpec(target="red", spectrum="batch"),
            ComponentSpec(target="dm", spectrum="batch"),
            curn,
        ))
        spec = SampleSpec(model=model, n_chains=args.chains,
                          n_temps=args.temps, step_size=args.step_size,
                          n_leapfrog=args.n_leapfrog, thin=args.thin,
                          warmup=args.warmup)
        study = SamplingRun(batch, spec, truth=truth, device=device,
                            data_seed=args.seed)
        out = study.run(args.steps, seed=args.seed, segment=args.segment,
                        checkpoint=args.checkpoint,
                        pipeline_depth=args.pipeline_depth)
    except (ValueError, TypeError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    row = {"npsr": args.npsr, "chains": args.chains, "temps": args.temps,
           "steps": args.steps, "model": "powerlaw" if args.powerlaw
           else "free_spectrum", "d": len(out["param_names"]),
           **out["summary"]}
    if args.out:
        row["artifact"] = study.save(args.out)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":                               # pragma: no cover
    sys.exit(main())
