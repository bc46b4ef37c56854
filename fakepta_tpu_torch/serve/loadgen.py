"""Synthetic load generator: the serving layer's built-in benchmark, the
one-pool part (port of ``fakepta_tpu.serve.loadgen``'s first half).

Drives a :class:`ServePool` with a reproducible stream of requests (sizes
drawn from a small palette), optionally measures the **serial baseline**
(the same request list dispatched one ``run(n, seed)`` at a time), and
returns one benchmark row with the SLO metrics and the coalescing
speedup. Correctness is asserted, not assumed: a sampled subset of served
responses is compared bit for bit against the same request served alone
at its bucket, and against its own solo ``run(n, seed)`` within the path's
tolerance.

Kept divergence from the JAX loadgen: the solo-run tolerance follows the
precision the pool's path ran (``SOLO_RTOL``): the JAX pool serves XLA
f32 (rtol 1e-5), the port's serves the ``fused`` path's bf16 operands by
default. The fleet, elastic, gateway and telemetry-overhead load
generators are ROADMAP Queue 1 item 11b slices 4 and 5.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from ..obs.timing import now
from .scheduler import ServeConfig, ServePool
from .spec import (ArraySpec, InferRequest, OSRequest, ServeBusy,
                   SimRequest)

#: default request-size palette: a few distinct sizes (not a continuum) so
#: the serial baseline warms a bounded set of shapes and the coalesced
#: path exercises several ladder buckets
DEFAULT_SIZES = (4, 8, 16, 32)

#: a served response against its solo ``run(n, seed)``, by the precision
#: the run took: curves within ``rtol`` relative plus ``rtol`` of the curve
#: scale, autos within ``rtol`` relative. The f32 figure is the JAX
#: loadgen's; the bf16 one is the engine's bf16 bound (a float32 residual
#: a ULP apart across chunk shapes can round to another bf16 operand)
SOLO_RTOL = {"f32": 1e-5, "bf16": 1e-2}

FLEET_NOT_PORTED = ("run_loadgen(fleet=...) drives a ServeFleet, which the "
                    "port does not have yet (ROADMAP Queue 1 item 11b "
                    "slice 4)")


def make_requests(spec: ArraySpec, n_requests: int, sizes: Sequence[int],
                  kind: str = "sim", seed: int = 0, lnlike=None,
                  deadline_s: Optional[float] = None):
    """The reproducible request list (seeds distinct per request)."""
    rng = np.random.default_rng(seed)
    ns = rng.choice(np.asarray(sizes, dtype=int), size=n_requests)
    reqs = []
    for i, n in enumerate(ns):
        req_seed = 1000 + i
        if kind == "sim":
            reqs.append(SimRequest(spec=spec, n=int(n), seed=req_seed,
                                   deadline_s=deadline_s))
        elif kind == "os":
            reqs.append(OSRequest(spec=spec, n=int(n), seed=req_seed,
                                  deadline_s=deadline_s))
        elif kind == "infer":
            reqs.append(InferRequest(spec=spec, n=int(n), seed=req_seed,
                                     deadline_s=deadline_s, lnlike=lnlike))
        else:
            raise ValueError(f"unknown request kind {kind!r}")
    return reqs


def _serial_baseline(sim, reqs, repeats: int = 3) -> dict:
    """The same requests, one ``run()`` dispatch each: per-request chunk
    shapes, warmed once per distinct size so the figure is steady-state
    dispatch cost. Best of ``repeats`` passes, so the reported speedup is
    the conservative one."""
    for n in sorted({r.n for r in reqs}):
        sim.run(n, seed=0, chunk=n, pipeline_depth=0, **reqs[0].run_kwargs())
    elapsed = float("inf")
    for _ in range(repeats):
        t0 = now()
        for r in reqs:
            sim.run(r.n, seed=r.seed, chunk=r.n, pipeline_depth=0,
                    **r.run_kwargs())
        elapsed = min(elapsed, now() - t0)
    return {"elapsed_s": elapsed, "qps": len(reqs) / elapsed,
            "real_per_s": sum(r.n for r in reqs) / elapsed}


def verify_response(sim, req, res) -> dict:
    """The RNG-lane contract on one served response, in its two layers:
    bit-identical to the same request served alone at the same bucket
    (cohort, padding and slot cannot change a response), and within
    :data:`SOLO_RTOL` of the path's precision of its solo ``run(n,
    seed)``. Raises AssertionError on either; returns the solo run's
    distance (``curves_err_over_scale``, ``autos_rel_err``)."""
    alone = sim.run(res.bucket, chunk=res.bucket, lanes=[(req.seed, req.n)],
                    pipeline_depth=0, **req.run_kwargs())
    if not (np.array_equal(alone["curves"][:req.n], res.curves)
            and np.array_equal(alone["autos"][:req.n], res.autos)):
        raise AssertionError(
            f"served response (seed {req.seed}) differs from the same "
            f"request served alone at bucket {res.bucket}: the RNG-lane "
            f"contract is broken")
    solo = sim.run(req.n, seed=req.seed, chunk=req.n, pipeline_depth=0,
                   **req.run_kwargs())
    rtol = SOLO_RTOL[solo["precision"]]
    scale = float(np.abs(solo["curves"]).max()) or 1.0
    err = {"curves_err_over_scale":
           float(np.abs(solo["curves"] - res.curves).max()) / scale,
           "autos_rel_err": float(np.max(np.abs(solo["autos"] - res.autos)
                                         / np.abs(solo["autos"])))}
    if not (np.allclose(solo["curves"], res.curves, rtol=rtol,
                        atol=rtol * scale)
            and np.allclose(solo["autos"], res.autos, rtol=rtol)):
        raise AssertionError(
            f"served response (seed {req.seed}) disagrees with its solo run "
            f"beyond the {solo['precision']} tolerance {rtol}: {err}")
    return err


def run_loadgen(spec: Optional[ArraySpec] = None, *, mesh=None,
                n_requests: int = 64, sizes: Sequence[int] = DEFAULT_SIZES,
                kind: str = "sim", rate_hz: Optional[float] = None,
                seed: int = 0, baseline: bool = False, verify: int = 3,
                config: Optional[ServeConfig] = None,
                report_path=None, lnlike=None, fleet=None,
                device=None) -> dict:
    """Generate load, serve it, return one benchmark row (module doc).

    ``rate_hz`` paces submissions open-loop (None = as fast as admission
    allows: the max-coalescing regime); ``verify`` checks that many served
    responses (:func:`verify_response`); ``baseline=True`` adds the serial
    figures and the ``serve_speedup_x`` ratio. The pool runs on ``mesh``,
    else on ``device`` (default ``"cuda"``). ``fleet`` raises
    ``NotImplementedError`` (ROADMAP Queue 1 item 11b slice 4).

    Beside the JAX row's keys the row carries ``serve_warm_s_by_bucket``
    (the warm-up seconds of each ladder bucket) and, with ``verify``,
    ``serve_verify_err`` (the worst solo-run distance).
    """
    if fleet is not None:
        raise NotImplementedError(FLEET_NOT_PORTED)
    spec = spec or ArraySpec()
    pool = ServePool(mesh=mesh, config=config, device=device)
    reqs = make_requests(spec, n_requests, sizes, kind=kind, seed=seed,
                         lnlike=lnlike)
    warm_by_bucket = {}
    try:
        # warmup: one full-bucket request per ladder bucket, served to
        # completion before the next (submitted together they would
        # coalesce into one bigger bucket), so the measured window
        # reports steady-state serving
        for b in pool.buckets:
            t0 = now()
            pool.submit(dataclasses.replace(reqs[0], n=b,
                                            seed=0)).result(timeout=600.0)
            warm_by_bucket[str(b)] = round(now() - t0, 4)
        pool.reset_stats()

        futs = []
        for r in reqs:
            while True:
                try:
                    futs.append(pool.submit(r))
                    break
                except ServeBusy as busy:
                    # honor the scheduler's Retry-After hint
                    time.sleep(max(getattr(busy, "retry_after_s", 0.0),
                                   0.002))
            if rate_hz:
                time.sleep(1.0 / rate_hz)
        results = [f.result(timeout=600.0) for f in futs]
        row = dict(pool.slo_summary())
        row["serve_kind"] = kind
        row["serve_warm_s_by_bucket"] = warm_by_bucket

        if verify:
            entry = pool._pool.get(spec.spec_hash(), spec)
            rng = np.random.default_rng(seed + 1)
            worst = {}
            for idx in rng.choice(len(reqs), size=min(verify, len(reqs)),
                                  replace=False):
                err = verify_response(entry.sim, reqs[idx], results[idx])
                worst = {k: max(v, worst.get(k, 0.0))
                         for k, v in err.items()}
            row["serve_verified"] = int(min(verify, len(reqs)))
            row["serve_verify_err"] = worst
        if report_path is not None:
            pool.save_report(report_path)
    finally:
        pool.close()

    if baseline:
        sim = spec.build(mesh=pool.mesh)
        ser = _serial_baseline(sim, reqs)
        n_dev = pool.n_devices
        row["serve_serial_qps_per_chip"] = round(ser["qps"] / n_dev, 3)
        if ser["qps"] > 0 and row.get("serve_qps_per_chip"):
            row["serve_speedup_x"] = round(
                row["serve_qps_per_chip"] / (ser["qps"] / n_dev), 2)
    return row
