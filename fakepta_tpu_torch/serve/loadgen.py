"""Synthetic load generators: the serving layer's built-in benchmarks
(port of ``fakepta_tpu.serve.loadgen``).

Drives a :class:`ServePool` with a reproducible stream of requests (sizes
drawn from a small palette), optionally measures the **serial baseline**
(the same request list dispatched one ``run(n, seed)`` at a time), and
returns one benchmark row with the SLO metrics and the coalescing
speedup. Correctness is asserted, not assumed: a sampled subset of served
responses is compared bit for bit against the same request served alone
at its bucket, and against its own solo ``run(n, seed)`` within the path's
tolerance.

The fleet modes (:func:`run_fleet_loadgen`, :func:`run_elastic_loadgen`,
:func:`measure_telemetry_overhead`) drive a :class:`.fleet.ServeFleet` of
in-process or subprocess replicas over a sharded-spec workload, with
every failed-over response bit-verified against the same request served
alone. The gateway mode (:func:`make_tenant_requests`,
:func:`run_gateway_loadgen`) drives a :class:`..gateway.Gateway` in front
of in-process replicas with a Zipfian multi-tenant mix, a background
appender and a mid-load stream cutover.

Kept divergences from the JAX loadgen: the solo-run tolerance follows the
precision the pool's path ran (``SOLO_RTOL``): the JAX pool serves XLA
f32 (rtol 1e-5), the port's serves the ``fused`` path's bf16 operands by
default. Every pool and replica serves on ``device`` (default
``"cuda"``), or replica i on ``devices[i]``; ``compile_cache_dir`` must
be ``None`` (replicas share the kernel build directory instead).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from .. import faults as faults_mod
from ..obs import flightrec
from ..obs.timing import now
from .scheduler import ServeConfig, ServePool
from .spec import (AppendRequest, ArraySpec, InferRequest, OSRequest,
                   ServeBusy, SimRequest, StreamRequest, no_compile_cache)

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
                compile_cache_dir: Optional[str] = None,
                report_path=None, lnlike=None, fleet=None,
                fleet_transport: str = "process", n_specs: int = 6,
                kill_one_at: Optional[float] = None, device=None) -> dict:
    """Generate load, serve it, return one benchmark row (module doc).

    ``rate_hz`` paces submissions open-loop (None = as fast as admission
    allows: the max-coalescing regime); ``verify`` checks that many served
    responses (:func:`verify_response`); ``baseline=True`` adds the serial
    figures and the ``serve_speedup_x`` ratio. The pool runs on ``mesh``,
    else on ``device`` (default ``"cuda"``).

    ``fleet`` switches to the multi-replica mode
    (:func:`run_fleet_loadgen`): an int spawns that many replicas
    (``fleet_transport`` picks subprocess sockets or in-process pools), a
    prebuilt :class:`.fleet.ServeFleet` is driven as it is.

    Beside the JAX row's keys the row carries ``serve_warm_s_by_bucket``
    (the warm-up seconds of each ladder bucket) and, with ``verify``,
    ``serve_verify_err`` (the worst solo-run distance).
    """
    no_compile_cache(compile_cache_dir)
    if fleet is not None:
        return run_fleet_loadgen(
            spec=spec, fleet=fleet, transport=fleet_transport,
            n_requests=n_requests, sizes=sizes, kind=kind, seed=seed,
            baseline=baseline, verify=verify, n_specs=n_specs,
            kill_one_at=kill_one_at, config=config,
            report_path=report_path, mesh=mesh, device=device)
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


# ---------------------------------------------------------------------------
# multi-replica (fleet) mode
# ---------------------------------------------------------------------------

def make_fleet_requests(specs: Sequence[ArraySpec], n_requests: int,
                        sizes: Sequence[int], kind: str = "sim",
                        seed: int = 0):
    """The fleet's reproducible request list: sizes from the palette,
    specs CYCLED in order (the LRU-adversarial access pattern: a single
    pool whose ``max_specs`` is below the working set misses on nearly
    every request while the sharded fleet stays hot)."""
    rng = np.random.default_rng(seed)
    ns = rng.choice(np.asarray(sizes, dtype=int), size=n_requests)
    reqs = []
    for i, n in enumerate(ns):
        spec = specs[i % len(specs)]
        req_seed = 1000 + i
        if kind == "sim":
            reqs.append(SimRequest(spec=spec, n=int(n), seed=req_seed))
        elif kind == "os":
            reqs.append(OSRequest(spec=spec, n=int(n), seed=req_seed))
        else:
            raise ValueError(f"fleet loadgen serves sim/os requests, "
                             f"not {kind!r}")
    return reqs


def _replica_device(i: int, device, devices) -> str:
    """Replica ``i``'s device: ``devices[i]`` (cycled) when given, else
    ``device`` (default ``"cuda"``)."""
    if devices:
        return str(devices[i % len(devices)])
    return "cuda" if device is None else str(device)


def _build_fleet(n_replicas: int, transport: str, spec: ArraySpec,
                 config, mesh, device=None, devices=None,
                 report_dir=None):
    """N replicas behind the router: subprocess sockets (spawned
    concurrently, so start-up is one cold-start wall; each replica's
    ``ready_s`` is its spawn-to-banner seconds) or in-process pools.
    ``report_dir``: each socket replica writes its RunReport there as
    ``replica-<i>.jsonl`` when it is closed."""
    import os
    import threading

    from .fleet import FleetConfig, LocalReplica, ServeFleet, SocketReplica

    if transport == "inproc":
        replicas = [LocalReplica(
            f"r{i}", mesh=mesh, config=config, index=i,
            device=None if mesh is not None else _replica_device(
                i, device, devices))
            for i in range(n_replicas)]
        return ServeFleet(replicas, FleetConfig())
    if transport != "process":
        raise ValueError(f"unknown fleet transport {transport!r}")
    if mesh is not None:
        raise ValueError("socket replicas take device= / devices=, not a "
                         "mesh (a mesh does not cross processes)")
    buckets = tuple(config.buckets) if config is not None else None
    out: list = [None] * n_replicas
    errs: list = []

    def spawn(i):
        try:
            t0 = now()
            out[i] = SocketReplica(
                f"r{i}", spec_defaults=spec, buckets=buckets, index=i,
                device=_replica_device(i, device, devices),
                report_path=(os.path.join(report_dir, f"replica-{i}.jsonl")
                             if report_dir is not None else None))
            out[i].ready_s = now() - t0
        except Exception as exc:   # noqa: BLE001 — re-raised below
            errs.append(exc)

    threads = [threading.Thread(target=spawn, args=(i,))
               for i in range(n_replicas)]
    for t in threads:
        t.start()
    for t in threads:
        # bounded: a wedged replica spawn surfaces as a startup failure
        # (its None slot below), never a hung loadgen
        t.join(300.0)
        if t.is_alive():
            flightrec.note("fleet_spawn_join_timeout", timeout_s=300.0)
    if errs or any(r is None for r in out):
        for r in out:
            if r is not None:
                r.close()
        raise RuntimeError(f"fleet startup failed: {errs!r}")
    return ServeFleet(out, FleetConfig())


def _submit_politely(fleet, req, futs):
    """Admission with the backpressure contract: honor aggregated
    Retry-After hints instead of hammering."""
    while True:
        try:
            futs.append(fleet.submit(req))
            return
        except ServeBusy as busy:
            time.sleep(max(getattr(busy, "retry_after_s", 0.0), 0.002))


def _verify_fleet_responses(reqs, results, verify: int, seed: int, mesh,
                            device=None) -> set:
    """The RNG-lane contract on fleet traffic: ``verify`` sampled
    responses PLUS every failed-over response, bit-compared against the
    same request served alone at the same bucket on ``mesh`` (else on
    ``device``, default ``"cuda"``). Returns the verified index set."""
    from ..parallel.mesh import make_mesh

    rng = np.random.default_rng(seed + 1)
    done = [i for i, r in enumerate(results) if r is not None]
    picks = set(rng.choice(done, size=min(verify, len(done)),
                           replace=False).tolist())
    picks |= {i for i in done if results[i].failovers > 0}
    sims: dict = {}
    solo_mesh = mesh or make_mesh(["cuda" if device is None else device])
    for i in sorted(picks):
        r, res = reqs[i], results[i]
        sh = r.spec.spec_hash()
        if sh not in sims:
            sims[sh] = r.spec.build(mesh=solo_mesh)
        alone = sims[sh].run(res.bucket, chunk=res.bucket,
                             lanes=[(r.seed, r.n)],
                             pipeline_depth=0, **r.run_kwargs())
        if not (np.array_equal(alone["curves"][:r.n], res.curves)
                and np.array_equal(alone["autos"][:r.n], res.autos)):
            raise AssertionError(
                f"fleet response for request {i} (replica "
                f"{res.replica}, failovers {res.failovers}) "
                f"differs from the same request served alone: "
                f"the RNG-lane contract is broken")
    return picks


def _collect(futs):
    """Every future's result, a lost request (``None``) counted."""
    results, lost = [], 0
    for f in futs:
        try:
            results.append(f.result(timeout=600.0))
        except Exception as exc:   # noqa: BLE001 — recorded and counted:
            # a lost accepted request is THE failover acceptance failure,
            # surfaced in the row (fleet_lost_requests != 0)
            flightrec.note("fleet_request_lost", error=repr(exc)[:200])
            results.append(None)
            lost += 1
    return results, lost


def run_fleet_loadgen(spec: Optional[ArraySpec] = None, *, fleet=3,
                      transport: str = "process", n_requests: int = 96,
                      sizes: Sequence[int] = (1, 2, 4), kind: str = "sim",
                      seed: int = 0, baseline: bool = False,
                      verify: int = 3, n_specs: int = 6,
                      kill_one_at: Optional[float] = None, config=None,
                      compile_cache_dir: Optional[str] = None,
                      report_path=None, mesh=None, device=None,
                      devices=None) -> dict:
    """Drive a replica fleet with a sharded-spec workload; one row.

    The traffic cycles ``n_specs`` distinct specs (same shapes, distinct
    ``data_seed``). The measured comparison (``baseline=True``) is the
    SAME request list through one ``ServePool`` on one device: on one
    card the fleet's win is aggregate warm capacity (N x ``max_specs``
    resident specs against one pool thrashing its LRU); with a card a
    replica (``devices``) the N dispatchers also run in parallel.
    ``kill_one_at`` kills the first spec's owner replica mid-load; the
    row then records ``fleet_lost_requests`` (0 is the acceptance) and
    every failed-over response is bit-verified like any other.

    Beside the JAX row's keys: ``fleet_ready_s`` (each spawned replica's
    start-up seconds), ``fleet_devices`` and, after a kill of a replica
    that reports them, ``fleet_killed_kernels`` (its last kernel counts).
    A prebuilt fleet's ``fleet_transport`` is ``"process"`` when every
    replica is a socket replica (the JAX row says ``"inproc"`` for any
    prebuilt fleet).
    """
    import dataclasses as dc

    from .fleet import SocketReplica

    no_compile_cache(compile_cache_dir)
    base = spec or ArraySpec(npsr=8, ntoa=64, n_red=4, n_dm=4, gwb_ncomp=4)
    specs = [dc.replace(base, data_seed=100 + i) for i in range(n_specs)]
    reqs = make_fleet_requests(specs, n_requests, sizes, kind=kind,
                               seed=seed)
    if config is None:
        from ..tune import defaults as tune_defaults
        config = ServeConfig(buckets=tune_defaults.DEFAULT_FLEET_BUCKETS)
    own_fleet = isinstance(fleet, int)
    flt = fleet if not own_fleet else _build_fleet(
        fleet, transport, base, config, mesh, device=device,
        devices=devices)
    kill_rid = None
    warm_buckets = sorted({int(b) for b in config.buckets})
    try:
        ready = {rid: round(r.ready_s, 3)
                 for rid, r in flt.replicas.items() if hasattr(r, "ready_s")}
        # warm-up: each spec's owner serves one request per ladder bucket,
        # so the measured window is steady-state
        for s in specs:
            for b in warm_buckets:
                flt.serve(dc.replace(reqs[0], spec=s, n=b, seed=0),
                          timeout=600.0)
        flt.reset_stats()

        if kill_one_at is not None:
            kill_rid = flt.ring.owner(specs[0].spec_hash())
        kill_at = (int(kill_one_at * len(reqs))
                   if kill_one_at is not None else None)
        futs: list = []
        killed_kernels = None
        for i, r in enumerate(reqs):
            if kill_at is not None and i == kill_at:
                victim = flt.replicas[kill_rid]
                if hasattr(victim, "kernel_summary"):
                    # the victim's kernel counts die with it: keep the
                    # last reading
                    killed_kernels = victim.kernel_summary()
                flt._mark_dead(kill_rid, "loadgen chaos kill")
                victim.kill()
            _submit_politely(flt, r, futs)
        results, lost = _collect(futs)
        row = dict(flt.slo_summary())
        row["fleet_kind"] = kind
        # a prebuilt fleet's transport is its replicas'
        row["fleet_transport"] = transport if own_fleet else (
            "process" if all(isinstance(r, SocketReplica)
                             for r in flt.replicas.values()) else "inproc")
        row["fleet_lost_requests"] = lost
        row["fleet_ready_s"] = ready
        row["fleet_devices"] = sorted({d for r in flt.replicas.values()
                                       for d in r.device_ids()})
        if kill_at is not None:
            row["fleet_killed_replica"] = kill_rid
            if killed_kernels is not None:
                row["fleet_killed_kernels"] = killed_kernels

        if verify:
            picks = _verify_fleet_responses(
                reqs, results, verify, seed, mesh,
                device=_replica_device(0, device, devices))
            row["fleet_verified"] = len(picks)
            row["fleet_verified_failover"] = sum(
                1 for i in picks if results[i].failovers > 0)
        if report_path is not None:
            flt.report().save(report_path)
    finally:
        if own_fleet:
            flt.close()

    if baseline:
        # ONE pool, the SAME traffic: its LRU warm pool is the only spec
        # residency, so the working set thrashes it
        solo = ServePool(mesh=mesh, config=config,
                         device=None if mesh is not None else (
                             _replica_device(0, device, devices)))
        try:
            for s in specs:
                for b in warm_buckets:
                    solo.submit(dc.replace(reqs[0], spec=s, n=b,
                                           seed=0)).result(timeout=600.0)
            solo.reset_stats()
            sfuts: list = []
            for r in reqs:
                _submit_politely(solo, r, sfuts)
            for f in sfuts:
                f.result(timeout=600.0)
            ssum = solo.slo_summary()
        finally:
            solo.close()
        row["fleet_solo_qps"] = ssum.get("serve_qps_per_chip", 0.0) \
            * solo.n_devices
        row["fleet_solo_p50_ms"] = ssum.get("serve_p50_ms", 0.0)
        if row["fleet_solo_qps"] > 0 and row.get("fleet_qps"):
            row["fleet_speedup_x"] = round(
                row["fleet_qps"] / row["fleet_solo_qps"], 2)
    return row


# ---------------------------------------------------------------------------
# elastic chaos mode
# ---------------------------------------------------------------------------

def export_fleet_trace(flt, trace_path) -> dict:
    """One merged, validated Chrome trace for a live fleet: the router's
    report (``route`` spans and failover instants) plus every in-process
    replica's report (a pid lane each). Spans sharing a request
    ``trace_id`` (a failed-over request's spans on the dead and surviving
    replicas too) come out linked by flow events. Returns summary counts
    (``flows``: the trace-id flow links)."""
    import json

    from ..obs import trace as tracefmt

    reports = [flt.report()] + flt.replica_reports()
    trace = tracefmt.build_trace(reports)
    tracefmt.validate_trace(trace)
    with open(trace_path, "w") as fh:
        json.dump(trace, fh)
    return {"path": str(trace_path), "shards": len(reports),
            "flows": int(trace["metadata"].get("flows", 0))}


def measure_telemetry_overhead(spec: Optional[ArraySpec] = None, *,
                               n_replicas: int = 2, n_requests: int = 48,
                               sizes: Sequence[int] = (1, 2), seed: int = 0,
                               n_specs: int = 2, config=None,
                               compile_cache_dir: Optional[str] = None,
                               mesh=None, health_config=None,
                               rounds: int = 3, device=None) -> dict:
    """A/B the telemetry plane's serving cost: the same in-process fleet
    workload with the heartbeat scrape ON (``scrape_every=1``) against OFF
    (``scrape_every=0``), the health plane running in both arms so the
    delta isolates the scrape. The arms alternate for ``rounds`` bursts
    and each reports its best round. Returns ``telemetry_qps_on`` /
    ``telemetry_qps_off`` / ``telemetry_overhead_frac``."""
    import dataclasses as dc

    from .health import HealthConfig

    no_compile_cache(compile_cache_dir)
    base = spec or ArraySpec(npsr=8, ntoa=64, n_red=4, n_dm=4, gwb_ncomp=4)
    specs = [dc.replace(base, data_seed=100 + i) for i in range(n_specs)]
    reqs = make_fleet_requests(specs, n_requests, sizes, seed=seed)
    if config is None:
        from ..tune import defaults as tune_defaults
        config = ServeConfig(buckets=tune_defaults.DEFAULT_FLEET_BUCKETS)
    hc = health_config or HealthConfig(period_s=0.02,
                                       probe_deadline_s=0.25)
    warm_buckets = sorted({int(b) for b in config.buckets})
    fleets = {}
    qps = {"off": 0.0, "on": 0.0}
    try:
        for arm, scrape_every in (("off", 0), ("on", 1)):
            flt = fleets[arm] = _build_fleet(n_replicas, "inproc", base,
                                             config, mesh, device=device)
            for s in specs:
                for b in warm_buckets:
                    flt.serve(dc.replace(reqs[0], spec=s, n=b, seed=0),
                              timeout=600.0)
            flt.enable_health(dc.replace(hc, scrape_every=scrape_every))
        for _ in range(max(1, int(rounds))):
            for arm in ("off", "on"):
                flt = fleets[arm]
                flt.reset_stats()
                futs: list = []
                for r in reqs:
                    _submit_politely(flt, r, futs)
                for f in futs:
                    f.result(timeout=600.0)
                qps[arm] = max(qps[arm],
                               float(flt.slo_summary().get("fleet_qps",
                                                           0.0)))
    finally:
        for flt in fleets.values():
            flt.close()
    frac = (max(0.0, 1.0 - qps["on"] / qps["off"])
            if qps["off"] > 0 else 0.0)
    return {"telemetry_qps_on": round(qps["on"], 3),
            "telemetry_qps_off": round(qps["off"], 3),
            "telemetry_overhead_frac": round(frac, 4)}


def run_elastic_loadgen(spec: Optional[ArraySpec] = None, *,
                        n_replicas: int = 3, transport: str = "inproc",
                        n_requests: int = 96,
                        sizes: Sequence[int] = (1, 2, 4),
                        kind: str = "sim", seed: int = 0, verify: int = 3,
                        n_specs: int = 6, wedge_at: float = 0.2,
                        kill_at: float = 0.45, join_at: float = 0.7,
                        config=None,
                        compile_cache_dir: Optional[str] = None,
                        mesh=None, health_config=None,
                        hang_s: Optional[float] = None,
                        trace_path=None, device=None,
                        devices=None) -> dict:
    """The fleet lifecycle A/B: ramp load, wedge one replica, kill
    another, autoscale a third in; one row of acceptance evidence.

    At ``wedge_at`` of submissions a ``fleet.heartbeat`` hang fault
    (matched to one replica) wedges that replica's probes: the health
    plane must breaker it, drained of new routes with ZERO client-visible
    timeouts. At ``kill_at`` a different replica is killed outright. At
    ``join_at`` the autoscaler (tiny ``target_qps_per_replica``, zero
    cooldown: a deterministic scale-up) spawns and joins a fresh replica
    that prewarms its absorbed shard; its kernels come from the shared
    build directory, so it builds none (``fleet_join_steady_compiles``
    0, and on a socket replica ``fleet_join_nvcc_starts`` 0).

    Acceptance, recorded in the row: ``fleet_lost_requests == 0``,
    ``fleet_timeouts == 0``, the wedged replica breakered
    (``fleet_wedge_state`` suspect / wedged), ``fleet_joins >= 1`` and
    every failed-over response bit-verified (:func:`_verify_fleet_responses`).
    ``trace_path`` exports the run's merged Chrome trace
    (:func:`export_fleet_trace`; ``row["trace_flows"]``).
    """
    import dataclasses as dc

    from .autoscale import AutoscaleConfig, Autoscaler
    from .fleet import LocalReplica, SocketReplica
    from .health import HealthConfig

    no_compile_cache(compile_cache_dir)
    base = spec or ArraySpec(npsr=8, ntoa=64, n_red=4, n_dm=4, gwb_ncomp=4)
    specs = [dc.replace(base, data_seed=100 + i) for i in range(n_specs)]
    reqs = make_fleet_requests(specs, n_requests, sizes, kind=kind,
                               seed=seed)
    if config is None:
        from ..tune import defaults as tune_defaults
        config = ServeConfig(buckets=tune_defaults.DEFAULT_FLEET_BUCKETS)
    warm_buckets = sorted({int(b) for b in config.buckets})
    hc = health_config or HealthConfig(
        period_s=0.05, probe_deadline_s=0.05, suspect_after=2,
        wedged_after=4, close_after=2, backoff_base_s=0.05,
        backoff_cap_s=0.2)
    hang_s = hang_s if hang_s is not None else 4.0 * hc.probe_deadline_s
    flt = _build_fleet(n_replicas, transport, base, config, mesh,
                       device=device, devices=devices)
    joined_id = None
    fault_cm = None
    try:
        for s in specs:
            for b in warm_buckets:
                flt.serve(dc.replace(reqs[0], spec=s, n=b, seed=0),
                          timeout=600.0)
        flt.enable_health(hc)
        flt.reset_stats()

        # victims, chosen BEFORE any membership change: the kill victim
        # owns the first spec; the wedge victim owns some other spec (or
        # is any other live replica when one owner holds both)
        kill_rid = flt.ring.owner(specs[0].spec_hash())
        wedge_rid = next(
            (flt.ring.owner(s.spec_hash()) for s in specs[1:]
             if flt.ring.owner(s.spec_hash()) != kill_rid),
            next(r for r in flt.replicas if r != kill_rid))

        def spawn(index):
            rid = f"scale{index}"
            dev = _replica_device(index, device, devices)
            if transport == "inproc":
                return LocalReplica(
                    rid, mesh=mesh, config=config, index=index,
                    device=None if mesh is not None else dev)
            rep = SocketReplica(rid, spec_defaults=base,
                                buckets=tuple(config.buckets), index=index,
                                device=dev)
            return rep

        scaler = Autoscaler(flt, spawn, AutoscaleConfig(
            min_replicas=1, max_replicas=n_replicas + 2,
            target_qps_per_replica=1e-6, cooldown_s=0.0))

        wedge_idx = int(wedge_at * len(reqs))
        kill_idx = int(kill_at * len(reqs))
        join_idx = int(join_at * len(reqs))
        futs: list = []
        for i, r in enumerate(reqs):
            if i == wedge_idx and faults_mod.active() is None:
                fault_cm = faults_mod.inject(faults_mod.FaultPlan([
                    faults_mod.FaultSpec(
                        "fleet.heartbeat", "hang", at=tuple(range(512)),
                        times=512, hang_s=hang_s,
                        match=(("replica", wedge_rid),))]))
                fault_cm.__enter__()
            if i == kill_idx:
                flt._mark_dead(kill_rid, "elastic loadgen chaos kill")
                flt.replicas[kill_rid].kill()
            if i == join_idx:
                # the scale-up must be deterministic: a window with fewer
                # than two completions reads fleet_qps 0.0, which the
                # policy would call over-provisioned; wait (bounded) for
                # measurable throughput first
                jd = now() + 60.0
                while (now() < jd
                       and flt.slo_summary().get("fleet_qps", 0.0) <= 0.0):
                    time.sleep(0.01)
                decision = scaler.step()
                if decision.get("action") == "up":
                    joined_id = decision.get("replica")
            _submit_politely(flt, r, futs)
        results, lost = _collect(futs)
        # the wedge is caught out of band: give the monitor a bounded
        # window to accumulate its consecutive misses
        deadline = now() + 20.0 * hang_s + 2.0
        while (now() < deadline
               and flt.health.state(wedge_rid) == "healthy"):
            time.sleep(0.02)
        row = dict(flt.slo_summary())
        row["fleet_kind"] = kind
        row["fleet_transport"] = transport
        row["fleet_lost_requests"] = lost
        row["fleet_killed_replica"] = kill_rid
        row["fleet_wedged_replica"] = wedge_rid
        row["fleet_wedge_state"] = flt.health.state(wedge_rid)
        row["scale_events"] = scaler.scale_events
        if joined_id is not None:
            row["fleet_joined_replica"] = joined_id
            joined = flt.replicas.get(joined_id)
            if joined is not None and joined.alive:
                try:
                    js = (joined.slo_summary()
                          if hasattr(joined, "slo_summary")
                          else joined.stats(timeout=60.0))
                    row["fleet_join_steady_compiles"] = int(
                        js.get("serve_steady_compiles", 0))
                    if isinstance(joined, SocketReplica):
                        row["fleet_join_nvcc_starts"] = int(
                            joined.kernel_summary(timeout=60.0).get(
                                "nvcc_starts", 0))
                except (ServeBusy, OSError, RuntimeError):
                    pass
        row["fleet_alerts"] = len(flt.telemetry.alerts.log)
        if trace_path is not None:
            row["trace_flows"] = export_fleet_trace(flt, trace_path)["flows"]
        if verify:
            picks = _verify_fleet_responses(
                reqs, results, verify, seed, mesh,
                device=_replica_device(0, device, devices))
            row["fleet_verified"] = len(picks)
            row["fleet_verified_failover"] = sum(
                1 for i in picks if results[i].failovers > 0)
    finally:
        if fault_cm is not None:
            fault_cm.__exit__(None, None, None)
        flt.close()
    return row


# ---------------------------------------------------------------------------
# multi-tenant gateway mode
# ---------------------------------------------------------------------------

def make_tenant_requests(specs: Sequence[ArraySpec], n_requests: int,
                         sizes: Sequence[int], n_identities: int = 12,
                         seed: int = 0, zipf_s: float = 1.4):
    """The Zipfian hot-spec request stream: a fixed pool of request
    *identities* (distinct ``(spec, seed, n)`` triples, each a distinct
    content address) drawn with popularity ``1/rank^s``, so the traffic
    keeps re-asking its hot identities. That is the regime the gateway's
    content-addressed store and single-flight table exist for: the first
    ask of an identity pays device time, every repeat is a hit (or rides
    the in-flight leader), and the tail identities keep the store's LRU
    honest. Returns ``(requests, identity_index_per_request)``."""
    rng = np.random.default_rng(seed)
    pool = []
    for k in range(n_identities):
        pool.append((specs[k % len(specs)], 1000 + k,
                     int(sizes[k % len(sizes)])))
    ranks = np.arange(1, n_identities + 1, dtype=float)
    probs = ranks ** -float(zipf_s)
    probs /= probs.sum()
    picks = rng.choice(n_identities, size=n_requests, p=probs)
    reqs = [SimRequest(spec=pool[k][0], n=pool[k][2], seed=pool[k][1])
            for k in picks]
    return reqs, [int(k) for k in picks]


def run_gateway_loadgen(spec: Optional[ArraySpec] = None, *,
                        n_tenants: int = 3, n_requests: int = 96,
                        sizes: Sequence[int] = (1, 2, 4), seed: int = 0,
                        n_specs: int = 3, n_identities: int = 12,
                        zipf_s: float = 1.4, n_replicas: int = 2,
                        max_inflight: int = 6, cutover_at: float = 0.5,
                        store_dir=None, config=None,
                        compile_cache_dir: Optional[str] = None,
                        mesh=None, device=None, devices=None) -> dict:
    """Drive a gateway-fronted fleet with a Zipfian multi-tenant mix;
    one row (the ``gw_*`` fields).

    ``n_replicas`` in-process replicas serve on ``device`` (default
    ``"cuda"``), or replica i on ``devices[i]``, or all on ``mesh``.
    Tenants get distinct auth tokens and a skewed traffic split (tenant 0
    is hot), against a deliberately small ``max_inflight`` so the hot
    tenant runs into its weighted fair share: every 429 must be a
    :class:`..gateway.GatewayBusy` carrying a positive per-tenant
    ``retry_after_s``; anything else refuses the row. A background
    appender keeps a gateway-opened stream ingesting through the measured
    window, and at ``cutover_at`` of submissions the stream is re-staged
    onto a 2x-Tspan template as a gateway-managed cutover: the final
    stream TOA count must equal exactly what the appender landed (zero
    dropped or duplicated appends) or the row is refused.

    Correctness is the gate, not a sample: EVERY response served from the
    result store is bit-compared against the same request served alone at
    its bucket (``run(bucket, lanes=[(seed, n)])`` on a simulator built
    the way the pool builds one, on replica 0's device: the pool's own
    path and precision), and every other response of the same identity
    (leaders, coalesced followers) must be bit-identical to the verified
    hit. Any mismatch raises: a hit-rate number can never ship from a
    wrong-answer cache.
    """
    import dataclasses as dc
    import tempfile
    import threading

    from ..gateway import Gateway, GatewayBusy, ResultStore, Tenant
    from ..parallel.mesh import make_mesh

    no_compile_cache(compile_cache_dir)
    base = spec or ArraySpec(npsr=8, ntoa=64, n_red=4, n_dm=4, gwb_ncomp=4)
    specs = [dc.replace(base, data_seed=100 + i) for i in range(n_specs)]
    reqs, idents = make_tenant_requests(specs, n_requests, sizes,
                                        n_identities=n_identities,
                                        seed=seed, zipf_s=zipf_s)
    # skewed tenant split: tenant 0 is hot (~half the traffic), the
    # starvation scenario the weighted fair share must absorb
    rng = np.random.default_rng(seed + 7)
    tranks = np.arange(1, n_tenants + 1, dtype=float)
    tprobs = tranks ** -1.5
    tprobs /= tprobs.sum()
    req_tenants = rng.choice(n_tenants, size=n_requests, p=tprobs)
    tenants = [Tenant(f"t{i}", token=f"tok-{i}",
                      weight=(2 if i == 0 else 1))
               for i in range(n_tenants)]
    tokens = {i: f"tok-{i}" for i in range(n_tenants)}

    if config is None:
        from ..tune import defaults as tune_defaults
        config = ServeConfig(buckets=tune_defaults.DEFAULT_FLEET_BUCKETS)
    warm_buckets = sorted({int(b) for b in config.buckets})
    flt = _build_fleet(n_replicas, "inproc", base, config, mesh,
                       device=device, devices=devices)
    store = ResultStore(store_dir
                        or tempfile.mkdtemp(prefix="fakepta-gw-loadgen-"))
    gw = Gateway(flt, tenants, store=store, max_inflight=max_inflight)

    stream_name = "gw-loadgen"
    stream_spec = ArraySpec(npsr=4, ntoa=16, tspan_years=3.0, n_red=2,
                            n_dm=2, gwb_ncomp=2)
    span_s = 3.0 * 365.25 * 86400.0
    appended = {"toas": 0, "blocks": 0}
    stop = threading.Event()
    app_errs: list = []

    def _append_block(block_seed, spec_arg=None):
        brng = np.random.default_rng(block_seed)
        t = np.sort(brng.uniform(0.0, 0.9 * span_s, size=(4, 6)), axis=1)
        r = brng.normal(0.0, 1e-7, size=(4, 6))
        req = AppendRequest(stream=stream_name, toas=t, residuals=r,
                            spec=spec_arg)
        while True:
            try:
                gw.serve(req, token=tokens[n_tenants - 1], timeout=300.0)
                appended["toas"] += t.size
                appended["blocks"] += 1
                return
            except GatewayBusy as busy:
                time.sleep(max(busy.retry_after_s, 0.002))

    def _appender():
        k = 0
        while not stop.is_set():
            try:
                _append_block(10_000 + k)
            except Exception as exc:   # noqa: BLE001 (surfaced below: an
                # appender death must refuse the row, never pass as a
                # quiet ingestion gap the TOA-conservation check would
                # blame on the cutover)
                app_errs.append(exc)
                return
            k += 1
            time.sleep(0.005)

    cut_info: dict = {}
    try:
        for s in specs:
            for b in warm_buckets:
                flt.serve(dc.replace(reqs[0], spec=s, n=b, seed=0),
                          timeout=600.0)
        _append_block(9_999, spec_arg=stream_spec)   # opens the stream
        gw.reset_stats()
        appender = threading.Thread(target=_appender, daemon=True)
        appender.start()

        cut_idx = int(cutover_at * len(reqs))
        futs: list = []
        for i, r in enumerate(reqs):
            if i == cut_idx:
                cut_info = gw.cutover(
                    stream_name,
                    dc.replace(stream_spec, tspan_years=6.0))
            tok = tokens[int(req_tenants[i])]
            while True:
                try:
                    futs.append(gw.submit(r, token=tok))
                    break
                except GatewayBusy as busy:
                    # the per-tenant 429 contract IS the acceptance: a
                    # throttle without an actionable hint refuses the row
                    if busy.retry_after_s <= 0.0 or not busy.tenant:
                        raise RuntimeError(
                            f"gateway 429 without a per-tenant retry "
                            f"hint: tenant={busy.tenant!r} "
                            f"retry_after_s={busy.retry_after_s!r}")
                    time.sleep(busy.retry_after_s)
        results, lost = [], 0
        for f in futs:
            try:
                results.append(f.result(timeout=600.0))
            except Exception as exc:   # noqa: BLE001 (recorded + refused)
                flightrec.note("gateway_request_lost",
                               error=repr(exc)[:200])
                results.append(None)
                lost += 1
        if lost:
            raise RuntimeError(f"{lost} admitted request(s) lost: "
                               f"refusing to record the row")

        stop.set()
        appender.join(60.0)
        if appender.is_alive():
            flightrec.note("gateway_loadgen_appender_join_timeout",
                           timeout_s=60.0)
        if app_errs:
            raise RuntimeError(
                f"stream appender died mid-load: {app_errs[0]!r}")
        st = gw.serve(StreamRequest(stream=stream_name),
                      token=tokens[0], timeout=300.0)
        if int(st["n_toas"]) != appended["toas"]:
            raise RuntimeError(
                f"cutover dropped or duplicated appends: stream holds "
                f"{st['n_toas']} TOAs, appender landed "
                f"{appended['toas']}: refusing to record the row")

        # bit-verify EVERY store hit against the same request served
        # alone at its bucket, then pin every sibling response of the
        # same identity to the verified hit
        solo_mesh = mesh or make_mesh([_replica_device(0, device, devices)])
        sims: dict = {}
        by_ident: dict = {}
        for i, res in enumerate(results):
            by_ident.setdefault(idents[i], []).append(i)
        verified = 0
        for ident, idxs in sorted(by_ident.items()):
            hit_idx = [i for i in idxs
                       if results[i].replica == "gateway-cache"]
            if not hit_idx:
                continue
            i0 = hit_idx[0]
            r, res = reqs[i0], results[i0]
            sh = r.spec.spec_hash()
            if sh not in sims:
                sims[sh] = r.spec.build(mesh=solo_mesh)
            alone = sims[sh].run(res.bucket, chunk=res.bucket,
                                 lanes=[(r.seed, r.n)], pipeline_depth=0,
                                 **r.run_kwargs())
            if not (np.array_equal(alone["curves"][:r.n], res.curves)
                    and np.array_equal(alone["autos"][:r.n], res.autos)):
                raise RuntimeError(
                    f"cache hit for identity {ident} differs from its "
                    f"solo run: refusing to record the row")
            verified += 1
            for j in idxs:
                if j == i0:
                    continue
                if not (np.array_equal(results[j].curves, res.curves)
                        and np.array_equal(results[j].autos, res.autos)):
                    raise RuntimeError(
                        f"responses for identity {ident} disagree across "
                        f"the hit/leader/coalesced paths: refusing to "
                        f"record the row")
                verified += 1

        summ = gw.gateway_summary()
        trows = gw.tenant_summary()
        row = {
            "gw_requests": int(summ["requests"]),
            "gw_tenants": int(n_tenants),
            # the row's hit rate counts BOTH zero-device-work paths: the
            # store and the single-flight fold
            "gw_hit_rate": round(
                (summ["hits"] + summ["coalesced"]) / n_requests, 4),
            "gw_coalesced": int(summ["coalesced"]),
            "gw_throttles": int(summ["throttles"]),
            "gw_device_s_saved": float(summ["device_s_saved"]),
            "gw_p99_ms_under_quota": round(
                max((t["p99_ms"] for t in trows.values()), default=0.0),
                3),
            "gw_cutover_ms": float(cut_info.get("cutover_ms", 0.0)),
            "gw_verified": int(verified),
        }
    finally:
        stop.set()
        gw.close()
    return row
