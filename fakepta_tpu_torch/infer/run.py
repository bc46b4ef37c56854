"""InferenceRun: the host facade over the device lnlike lane (port of
fakepta_tpu.infer.run).

One object is one parameter-recovery study: it wraps an
:class:`~fakepta_tpu_torch.parallel.montecarlo.EnsembleSimulator` whose run
carries the GP-marginalized likelihood lane (``run(lnlike=...)``) and
reduces the packed per-realization lnL grid to recovery metrics (the
share of realizations whose maximum-likelihood grid point is the injected
truth, the mean normalized distance of the per-realization MAP from
truth) without any residual or (R, P, P) fetch. ``save()`` writes the
run's :class:`~fakepta_tpu_torch.obs.report.RunReport` as a JSON-lines
artifact in the JAX package's framing and ``fakepta_tpu.infer/1`` payload
schema.
"""

from __future__ import annotations

import pathlib

import numpy as np

from .model import (INFER_SCHEMA, CompiledLikelihood, InferSpec,
                    LikelihoodSpec, build, theta_grid)


class InferenceRun:
    """Grid-based likelihood study on the device lnlike lane.

    Parameters mirror :class:`EnsembleSimulator` (``batch``, ``gwb``,
    ``include``, ``mesh``, and ``device`` or any sampling configs through
    ``**sim_kwargs``; the device defaults to ``"cuda"``); ``model`` is a
    :class:`LikelihoodSpec`. Give ``theta`` explicitly or a ``grid_shape``
    to mesh the free parameters' box bounds; ``truth`` (a D-vector) enables
    the recovery metrics against its nearest grid point.
    """

    def __init__(self, batch, model: LikelihoodSpec, gwb=None, theta=None,
                 grid_shape=None, truth=None, mode="lnlike",
                 include=("white", "red", "dm", "gwb"), mesh=None,
                 **sim_kwargs):
        from ..parallel.montecarlo import EnsembleSimulator

        self.compiled: CompiledLikelihood = build(model, batch)
        if theta is None:
            theta = theta_grid(model, grid_shape if grid_shape is not None
                               else 5)
        self.spec = InferSpec(model=model,
                              theta=self.compiled.validate_theta(theta),
                              mode=mode)
        self.truth = None if truth is None else np.asarray(truth, dtype=float)
        if self.truth is not None and self.truth.shape != (self.compiled.D,):
            raise ValueError(f"truth must be a ({self.compiled.D},) vector "
                             f"for {list(self.compiled.param_names)}")
        self.sim = EnsembleSimulator(batch, gwb=gwb, include=include,
                                     mesh=mesh, **sim_kwargs)
        self.last_result = None

    def run(self, nreal: int, seed=0, chunk: int = 256) -> dict:
        """Run the study; returns the engine output dict plus ``summary``.

        ``out["lnlike"]`` holds the per-realization grid (lnl / grad /
        fisher per mode, schema ``fakepta_tpu.infer/1``);
        ``out["summary"]`` the flat metric dict the saved artifact exposes.
        """
        out = self.sim.run(nreal, seed=seed, chunk=chunk, lnlike=self.spec)
        lnl = out["lnlike"]["lnl"]
        theta = out["lnlike"]["theta"]
        map_idx = np.argmax(lnl, axis=1)
        summary = {
            "lnlike_grid_k": int(theta.shape[0]),
            "lnlike_lnl_max_mean": float(lnl.max(axis=1).mean()),
        }
        if self.truth is not None:
            # each dimension in units of the grid's span, so amplitude and
            # slope weigh alike in the distance
            span = np.maximum(theta.max(axis=0) - theta.min(axis=0), 1e-300)
            z = (theta - self.truth[None]) / span[None]
            truth_idx = int(np.argmin((z ** 2).sum(axis=1)))
            dist = np.sqrt((z[map_idx] ** 2).sum(axis=1))
            summary.update({
                "lnlike_map_hit_rate": round(
                    float((map_idx == truth_idx).mean()), 4),
                "lnlike_map_l2_mean": round(float(dist.mean()), 6),
            })
        if self.spec.mode == "fisher":
            # the observed Fisher information at each grid point: -H
            # averaged over realizations
            out["lnlike"]["fisher_mean"] = -out["lnlike"]["fisher"].mean(
                axis=0)
        out["summary"] = summary
        self.last_result = out
        return out

    def save(self, path, out=None) -> str:
        """Write the run's artifact (JSON-lines, the obs framing): a
        loadable :class:`~fakepta_tpu_torch.obs.report.RunReport` whose
        ``summary()`` merges the recovery metrics through the report's
        ``extra_metrics`` meta. Missing parent directories are made."""
        out = out if out is not None else self.last_result
        if out is None:
            raise ValueError("run() the study before saving its artifact")
        pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
        report = out["report"]
        report.meta["infer_schema"] = INFER_SCHEMA
        report.meta["extra_metrics"] = dict(out["summary"])
        return report.save(path)
