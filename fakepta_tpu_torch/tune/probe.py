"""Measured refinement: short probes through the run loop (port of
``fakepta_tpu.tune.probe``).

A probe is two ordinary :meth:`..parallel.montecarlo.EnsembleSimulator.run`
calls: one warm chunk (it bears the kernel builds and the first launches at
this shape), then ``PROBE_CHUNKS`` measured chunks, both through the same
``run(tuned=knobs)`` override a tuned run takes, so the tuner measures what
a tuned run executes. Everything read back comes from the RunReport: the
steady throughput and the allocator's ``peak_hbm_bytes``.

Two rules differ from the JAX package's probe (ROADMAP Queue 3):

- only an out-of-memory error or a watchdog abort scores a candidate as
  failed (``tune_probe_failed``). A kernel build or launch failure, or any
  other error, propagates out of the search: the tuner must not quietly
  tune around a broken kernel. So a probe runs with the recovery ladders
  off (``degrade_paths`` / ``degrade_precision``): a ``mega`` launch
  failure raises instead of stepping down to ``fused``;
- a probe run that still came back off its candidate's path or precision
  (``meta["degraded_path"]`` / ``["degraded_precision"]``, or another
  ``statistic_path``) is scored failed (``tune_probe_degraded``), or a
  ``mega`` label would carry a ``fused`` rate.
"""

from __future__ import annotations

from typing import Optional

from .. import faults
from ..obs import flightrec
from ..obs.timing import now
from . import defaults
from .model import Candidate


def _off_candidate(report, cand: Candidate) -> Optional[str]:
    """Why a probe run did not measure ``cand`` (None when it did)."""
    meta = report.meta
    for key in ("degraded_path", "degraded_precision"):
        if meta.get(key):
            return f"{key}={meta[key]}"
    if meta.get("statistic_path") != cand.path:
        return f"statistic_path={meta.get('statistic_path')}"
    if cand.precision is not None and meta.get("precision") != \
            cand.precision:
        return f"precision={meta.get('precision')}"
    return None


def run_probe(sim, cand: Candidate, *, seed: int = 2024,
              probe_chunks: int = defaults.PROBE_CHUNKS,
              timeout_s: float = defaults.PROBE_TIMEOUT_S,
              nreal_cap: Optional[int] = None) -> Optional[dict]:
    """Measure one candidate on a prepared simulator; None when it failed.

    ``sim`` already lives on the candidate's mesh split (the search builds
    one simulator per ``psr_shards``); path, precision, chunk and depth
    ride the ``tuned=`` override. ``nreal_cap`` (the search passes
    ``nreal_hint``) bounds the measured run at the workload scale.
    """
    knobs = cand.knobs()
    policy = faults.RecoveryPolicy(watchdog_s=timeout_s, backoff_s=0.0,
                                   max_retries=1, degrade_paths=False,
                                   degrade_precision=False)
    nreal = max(probe_chunks, 1) * cand.chunk
    if nreal_cap is not None:
        nreal = max(min(nreal, int(nreal_cap)), cand.chunk)
    t0 = now()
    try:
        warm = sim.run(cand.chunk, seed=seed, chunk=cand.chunk, tuned=knobs,
                       recovery=policy)
        out = sim.run(nreal, seed=seed + 1, chunk=cand.chunk, tuned=knobs,
                      recovery=policy)
    except Exception as exc:   # noqa: BLE001 — triaged: only these two
        # are a scored outcome, anything else propagates
        if not (faults.is_oom(exc)
                or isinstance(exc, faults.WatchdogTimeout)):
            raise
        flightrec.note("tune_probe_failed", knobs=str(knobs),
                       error=repr(exc)[:200])
        return None
    rep = out["report"]
    why = _off_candidate(warm["report"], cand) or _off_candidate(rep, cand)
    if why is not None:
        flightrec.note("tune_probe_degraded", knobs=str(knobs), why=why)
        return None
    rep_sum = rep.summary()
    rec = {
        "knobs": knobs,
        "real_per_s_per_chip": float(rep.steady_real_per_s_per_chip()),
        "probe_s": float(now() - t0),
        "retraces": int(rep.retraces),
        "peak_hbm_bytes": int(rep_sum.get("peak_hbm_bytes", 0)),
    }
    flightrec.note("tune_probe", knobs=str(knobs),
                   rate=round(rec["real_per_s_per_chip"], 2),
                   probe_s=round(rec["probe_s"], 3))
    return rec
