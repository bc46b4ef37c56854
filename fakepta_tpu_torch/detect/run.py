"""DetectionRun: the host facade over the device optimal-statistic lane.

Port of :mod:`fakepta_tpu.detect.run`. One object is one null-calibrated
detection study: it wraps an
:class:`~fakepta_tpu_torch.parallel.montecarlo.EnsembleSimulator` whose run
carries the OS lane with the paired noise-only stream
(``OSSpec(null=True)``), and reduces the packed lanes to the standard
detection summary (significance, detection rate at 5% false alarm, null
quantiles) without any (R, P, P) fetch. ``save()`` writes the run's
:class:`~fakepta_tpu_torch.obs.report.RunReport` as a JSON-lines artifact
whose ``summary()`` carries the detection metrics (``extra_metrics``), in
the JAX package's framing and ``fakepta_tpu.detect/1`` payload schema.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

from .operators import DETECT_SCHEMA, OSSpec, as_spec


class DetectionRun:
    """Null-calibrated GWB detection study on the device OS lane.

    Parameters mirror :class:`EnsembleSimulator` (``batch``, ``gwb``,
    ``include``, ``mesh``, and ``device`` or any sampling configs through
    ``**sim_kwargs``; the device defaults to ``"cuda"``); ``os`` is an ORF
    name, a sequence or an :class:`OSSpec`. Null calibration is forced on:
    the paired noise-only stream is the study's yardstick; the analytic
    sigma stays in the artifact for comparison.
    """

    def __init__(self, batch, gwb, os="hd", include=("white", "red", "dm",
                                                     "gwb"),
                 mesh=None, **sim_kwargs):
        from ..parallel.montecarlo import EnsembleSimulator

        spec = as_spec(os)
        if not spec.null:
            spec = dataclasses.replace(spec, null=True)
        self.spec: OSSpec = spec
        self.sim = EnsembleSimulator(batch, gwb=gwb, include=include,
                                     mesh=mesh, **sim_kwargs)
        self.last_result = None

    def run(self, nreal: int, seed=0, chunk: int = 1024) -> dict:
        """Run the study; returns the engine output dict plus ``summary``.

        ``out["os"]`` holds the per-ORF statistics (amp2, snr, null_amp2,
        p_value; schema ``fakepta_tpu.detect/1``); ``out["summary"]`` the
        flat metric dict the saved artifact exposes.
        """
        out = self.sim.run(nreal, seed=seed, chunk=chunk, os=self.spec)
        summary = {}
        for orf in out["os"]["orfs"]:
            s = out["os"]["stats"][orf]
            amp2, null = s["amp2"], s["null_amp2"]
            sigma = max(s["sigma_empirical"], 1e-300)
            q95 = s["null_quantiles"]["q95"]
            summary.update({
                f"os_{orf}_significance_sigma": round(
                    float((amp2.mean() - null.mean()) / sigma), 4),
                f"os_{orf}_detection_rate": round(
                    float((amp2 > q95).mean()), 4),
                f"os_{orf}_amp2_mean": float(amp2.mean()),
                f"os_{orf}_null_amp2_mean": float(null.mean()),
                f"os_{orf}_sigma_empirical": float(sigma),
                f"os_{orf}_sigma_analytic": float(s["sigma_analytic"]),
                f"os_{orf}_null_q95": float(q95),
                f"os_{orf}_p_value_median": float(
                    np.median(s["p_value"])),
            })
        out["summary"] = summary
        self.last_result = out
        return out

    def save(self, path, out=None) -> str:
        """Write the run's artifact (JSON-lines, the obs framing): a
        loadable :class:`~fakepta_tpu_torch.obs.report.RunReport` whose
        ``summary()`` merges the detection metrics through the report's
        ``extra_metrics`` meta. Missing parent directories are made."""
        out = out if out is not None else self.last_result
        if out is None:
            raise ValueError("run() the study before saving its artifact")
        pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
        report = out["report"]
        report.meta["detect_schema"] = DETECT_SCHEMA
        report.meta["extra_metrics"] = dict(out["summary"])
        return report.save(path)
