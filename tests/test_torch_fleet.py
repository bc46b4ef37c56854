"""The port's serve fleet router (``fakepta_tpu_torch.serve.fleet``) and
served streams (``serve/streams.py``) against the JAX package's, on the
CPU, with in-process replicas (``LocalReplica(device="cpu")``).

One module-scoped port fleet of two replicas and one JAX fleet serve the
same phases (tests/test_fleet.py's: a request per spec, then the first
again), so each replica builds its simulators once. Held:

- routing: the spec-hash ring owners are the JAX fleet's, and so are the
  request lists (``make_fleet_requests``), ``resolve_spec_hash`` and
  ``SampleSessionSpec.session_hash``;
- within the port: a routed response, a repeat and a mid-flight failover
  equal the same request served alone bit for bit;
- against JAX: the default served path (``fused``, bf16 operands) within
  1e-2 of the JAX fleet's curve scale, a registered ``einsum`` simulator
  within 1e-5 (the JAX fleet serves XLA f32);
- ``slo_summary`` with the JAX fleet's key set; the report, the pid-lane
  trace merge, backpressure and the wire helpers as in the JAX tests;
- the lock-order regressions (tests/test_concurrency_regressions.py) and
  the fleet's telemetry scrape, rollup and exposition;
- served streams (tests/test_stream.py:382-464): the pool executes
  ``append`` / ``stream`` requests, the accumulated moments agree with the
  JAX pool's served stream within 1e-10 relative, the fleet routes a
  stream with affinity, and a cutover under concurrent appends loses none.
"""

import dataclasses
import json
import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from fakepta_tpu.parallel.mesh import make_mesh as jax_mesh
from fakepta_tpu.serve import AppendRequest as JaxAppend
from fakepta_tpu.serve import FleetConfig as JaxFleetConfig
from fakepta_tpu.serve import LocalReplica as JaxLocal
from fakepta_tpu.serve import SampleSessionSpec as JaxSession
from fakepta_tpu.serve import ServeConfig as JaxConfig
from fakepta_tpu.serve import ServeFleet as JaxFleet
from fakepta_tpu.serve import ServePool as JaxPool
from fakepta_tpu.serve import SimRequest as JaxSim
from fakepta_tpu.serve import loadgen as jloadgen
from fakepta_tpu.serve.spec import ArraySpec as JaxSpec
from fakepta_tpu.serve.spec import resolve_spec_hash as jresolve
from fakepta_tpu_torch import faults
from fakepta_tpu_torch.parallel.montecarlo import EnsembleSimulator
from fakepta_tpu_torch.serve import (AppendRequest, ArraySpec, FleetConfig,
                                     HealthConfig, LocalReplica, OSRequest,
                                     SampleSessionSpec, ServeBusy,
                                     ServeConfig, ServeError, ServeFleet,
                                     ServePool, ServeTimeout, SimRequest,
                                     StreamRequest, loadgen)
from fakepta_tpu_torch.serve.fleet import ReplicaDead, SocketReplica
from fakepta_tpu_torch.serve.spec import resolve_spec_hash

SPEC_KW = dict(npsr=4, ntoa=32, n_red=3, n_dm=3, gwb_ncomp=3)
SPEC0 = ArraySpec(data_seed=100, **SPEC_KW)
SPEC1 = dataclasses.replace(SPEC0, data_seed=101)
JSPEC0 = JaxSpec(data_seed=100, **SPEC_KW)
JSPEC1 = dataclasses.replace(JSPEC0, data_seed=101)
CFG = dict(buckets=(8,), coalesce_window_s=0.01)
TOL = {"f32": 1e-5, "bf16": 1e-2}
T_OUT = 300
SCRAPE_HEALTH = HealthConfig(period_s=0.05, probe_deadline_s=0.5,
                             suspect_after=2, wedged_after=4, close_after=2,
                             backoff_base_s=0.02, backoff_cap_s=0.1,
                             scrape_every=1)


def _wait_for(pred, timeout_s=15.0, step=0.01):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


def _phases(flt, spec0, spec1, sim_cls):
    out = {"A": flt.serve(sim_cls(spec=spec0, n=5, seed=11), timeout=T_OUT),
           "B": flt.serve(sim_cls(spec=spec1, n=3, seed=22), timeout=T_OUT)}
    out["A2"] = flt.serve(sim_cls(spec=spec0, n=5, seed=11), timeout=T_OUT)
    return out


@pytest.fixture(scope="module")
def fleets():
    jflt = JaxFleet([JaxLocal(f"r{i}", mesh=jax_mesh(jax.devices()[:1]),
                              config=JaxConfig(**CFG), index=i)
                     for i in range(2)], JaxFleetConfig())
    flt = ServeFleet([LocalReplica(f"r{i}", config=ServeConfig(**CFG),
                                   index=i, device="cpu")
                      for i in range(2)], FleetConfig())
    try:
        jout = _phases(jflt, JSPEC0, JSPEC1, JaxSim)
        jout["slo"] = jflt.slo_summary()
        out = _phases(flt, SPEC0, SPEC1, SimRequest)
        # a registered einsum simulator on every replica: the JAX fleet's
        # f32 arithmetic, routed by its name
        batch, gwb = SPEC0.parts(device="cpu")
        for r in flt.replicas.values():
            r.pool.register("einsum", EnsembleSimulator(
                batch, gwb=gwb, nbins=SPEC0.nbins, stat_path="einsum",
                device="cpu"))
        out["E"] = flt.serve(SimRequest(spec="einsum", n=5, seed=11),
                             timeout=T_OUT)
        yield {"port": out, "jax": jout, "fleet": flt, "jfleet": jflt}
    finally:
        flt.close()
        jflt.close()


def test_fleet_routes_by_spec_hash_with_affinity(fleets):
    flt, jflt = fleets["fleet"], fleets["jfleet"]
    out = fleets["port"]
    owner0 = flt.ring.owner(SPEC0.spec_hash())
    owner1 = flt.ring.owner(SPEC1.spec_hash())
    assert (owner0, owner1) == (jflt.ring.owner(JSPEC0.spec_hash()),
                                jflt.ring.owner(JSPEC1.spec_hash()))
    assert out["A"].replica == owner0 and out["A2"].replica == owner0
    assert out["B"].replica == owner1
    assert [fleets["jax"][k].replica for k in ("A", "B", "A2")] == \
        [out[k].replica for k in ("A", "B", "A2")]
    assert out["A"].failovers == 0


def test_fleet_response_bit_identical_to_solo_run(fleets):
    flt, out = fleets["fleet"], fleets["port"]
    owner0 = flt.ring.owner(SPEC0.spec_hash())
    entry = flt.replicas[owner0].pool._pool.get(SPEC0.spec_hash(), SPEC0)
    alone = entry.sim.run(8, chunk=8, lanes=[(11, 5)], pipeline_depth=0)
    assert np.array_equal(out["A"].curves, alone["curves"][:5])
    assert np.array_equal(out["A"].autos, alone["autos"][:5])
    assert np.array_equal(out["A2"].curves, out["A"].curves)
    # a fresh simulator of the same spec on the same device: the router's
    # own solo run
    fresh = SPEC0.build(device="cpu").run(8, chunk=8, lanes=[(11, 5)],
                                          pipeline_depth=0)
    assert np.array_equal(out["A"].curves, fresh["curves"][:5])


@pytest.mark.parametrize("key,prec", [("A", "bf16"), ("B", "bf16"),
                                      ("E", "f32")])
def test_fleet_response_matches_the_jax_fleet(fleets, key, prec):
    got = fleets["port"][key]
    want = fleets["jax"]["A" if key == "E" else key]
    scale = np.abs(want.curves).max()
    np.testing.assert_allclose(got.curves, want.curves, rtol=0,
                               atol=TOL[prec] * scale)
    np.testing.assert_allclose(got.autos, want.autos, rtol=TOL[prec])
    assert (got.bucket, got.cohort_requests) == (want.bucket,
                                                 want.cohort_requests)


def test_slo_summary_has_the_jax_keys(fleets):
    slo = fleets["fleet"].slo_summary()
    assert set(slo) == set(fleets["jax"]["slo"])
    assert slo["fleet_steady_compiles"] == 0 and slo["fleet_retraces"] == 0
    assert slo["fleet_failed"] == 0 and slo["fleet_requests"] >= 3
    assert fleets["fleet"].n_chips == 1


def test_midflight_failover_is_bit_identical(fleets):
    """Kill the owner's dispatcher mid-flight (serve.dispatch kill): the
    router re-dispatches the request to the ring sibling, whose response
    is bit-identical, and the dead replica stays dead."""
    flt, out = fleets["fleet"], fleets["port"]
    owner0 = flt.ring.owner(SPEC0.spec_hash())
    sibling = flt.ring.preference(SPEC0.spec_hash())[1]
    plan = faults.FaultPlan(
        [faults.FaultSpec("serve.dispatch", "kill", at=(0,))])
    with faults.inject(plan):
        res = flt.serve(SimRequest(spec=SPEC0, n=5, seed=11), timeout=T_OUT)
    assert res.replica == sibling and res.failovers == 1
    assert not flt.replicas[owner0].alive
    assert np.array_equal(res.curves, out["A"].curves)
    assert np.array_equal(res.autos, out["A"].autos)
    slo = flt.slo_summary()
    assert slo["fleet_failovers"] >= 1 and slo["fleet_replica_deaths"] >= 1
    again = flt.serve(SimRequest(spec=SPEC1, n=3, seed=22), timeout=T_OUT)
    assert np.array_equal(again.curves, out["B"].curves)


def test_fleet_report_and_pid_lane_merge(fleets):
    """The fleet rollup is an obs artifact and the replica reports merge
    into one Chrome trace with a pid lane per replica."""
    from fakepta_tpu_torch.obs.trace import build_trace, validate_trace

    flt = fleets["fleet"]
    rep = flt.report()
    assert rep.meta["kind"] == "serve_fleet"
    summ = rep.summary()
    assert summ["fleet_requests"] >= 4
    assert summ["fleet_steady_compiles"] == 0 and summ["fleet_retraces"] == 0
    reports = flt.replica_reports()
    assert reports and {r.meta["process_index"] for r in reports} <= {0, 1}
    trace = build_trace(reports)
    validate_trace(trace)
    assert len({e["pid"] for e in trace["traceEvents"]}) == len(reports)
    assert any(e.get("name") == "route" for e in rep.timeline)


def test_fleet_metric_directions_equal_jax():
    from fakepta_tpu.obs import report as jreport
    from fakepta_tpu_torch.obs import gate
    from fakepta_tpu_torch.obs import report

    keys = ("fleet_qps_per_chip", "fleet_speedup_x", "fleet_warm_hit_rate",
            "fleet_p50_ms", "fleet_p99_ms", "fleet_failovers",
            "fleet_lost_requests", "fleet_steady_compiles",
            "fleet_replicas", "fleet_transport")
    for k in keys:
        assert report.metric_higher_is_better(k) == \
            jreport.metric_higher_is_better(k), k
        assert report.metric_exempt(k) == jreport.metric_exempt(k), k
    hist = [{"platform": "cpu", "fleet_qps_per_chip": 100.0 * j,
             "fleet_p99_ms": 30.0} for j in (0.98, 1.02)]
    head = {"platform": "cpu", "fleet_qps_per_chip": 40.0,
            "fleet_p99_ms": 120.0}
    verdicts = {r.metric: r.verdict for r in gate.gate_row(head, hist)}
    assert verdicts["fleet_qps_per_chip"] == "regression"
    assert verdicts["fleet_p99_ms"] == "regression"


def test_fleet_backpressure_aggregates_hints_without_building():
    """Saturate both replicas' router-side in-flight bound with requests
    that never dispatch (a long window and deadlines): the fleet 429
    carries an aggregated hint, spillover tries the sibling first, and
    nothing is ever built."""
    cfg = ServeConfig(buckets=(8,), coalesce_window_s=30.0)
    flt = ServeFleet([LocalReplica(f"b{i}", config=cfg, index=i,
                                   device="cpu") for i in range(2)],
                     FleetConfig(max_inflight_per_replica=1))
    try:
        futs = [flt.submit(SimRequest(spec=SPEC0, n=2, seed=s,
                                      deadline_s=0.05)) for s in (1, 2)]
        with pytest.raises(ServeBusy) as exc_info:
            flt.submit(SimRequest(spec=SPEC0, n=2, seed=3))
        assert exc_info.value.retry_after_s >= 0.0
        slo = flt.slo_summary()
        assert slo["fleet_rejected"] == 1 and slo["fleet_spillovers"] >= 1
        for f in futs:
            with pytest.raises(ServeTimeout):
                f.result(timeout=60)
        with pytest.raises(ValueError, match="bucket ladder"):
            flt.submit(SimRequest(spec=SPEC0, n=64, seed=4))
        assert all(r.pool.warm_summary()["builds"] == 0
                   for r in flt.replicas.values())
    finally:
        flt.close()


def test_request_json_roundtrip_and_busy_hint_crosses_wire():
    """The protocol halves agree (request_to_json -> request_from_json),
    a busy error line carries the hint the router aggregates, and a
    full-emit response line becomes the pool's ServeResult again."""
    from fakepta_tpu_torch.serve.cli import (error_json, request_from_json,
                                             request_to_json, response_json)
    from fakepta_tpu_torch.serve.fleet import _result_from_json
    from fakepta_tpu_torch.serve.scheduler import ServeResult

    r = OSRequest(spec=SPEC0, n=4, seed=9, deadline_s=0.25, orf="dipole",
                  null=True)
    d = request_to_json(r, 7)
    assert d["id"] == 7 and d["deadline_ms"] == 250.0
    assert request_from_json(json.loads(json.dumps(d)), None) == r
    err = error_json(3, ServeBusy("full", retry_after_s=0.125))
    assert err["code"] == "busy" and err["retry_after_s"] == 0.125
    res = ServeResult(curves=np.arange(6, dtype=np.float32).reshape(2, 3),
                      autos=np.array([1.5, 2.5], dtype=np.float32),
                      bin_centers=np.array([0.1, 0.2, 0.3]), bucket=8,
                      cohort_requests=2)
    back = _result_from_json(json.loads(json.dumps(
        response_json(1, res, "full"))))
    assert np.array_equal(back.curves, res.curves)
    assert np.array_equal(back.autos, res.autos)
    assert (back.bucket, back.cohort_requests) == (8, 2)
    assert _result_from_json({"id": 1, "ok": True, "pong": True}) == \
        {"pong": True}
    assert _result_from_json({"id": 1, "ok": True,
                              "stream": {"n_toas": 3}}) == {"n_toas": 3}


def test_make_fleet_requests_equals_jax():
    specs = [dataclasses.replace(SPEC0, data_seed=100 + i) for i in range(3)]
    jspecs = [dataclasses.replace(JSPEC0, data_seed=100 + i)
              for i in range(3)]
    for kind in ("sim", "os"):
        got = loadgen.make_fleet_requests(specs, 17, (1, 2, 4), kind=kind,
                                          seed=5)
        want = jloadgen.make_fleet_requests(jspecs, 17, (1, 2, 4),
                                            kind=kind, seed=5)
        assert [(r.kind, r.n, r.seed, r.spec.spec_hash()) for r in got] == \
            [(r.kind, r.n, r.seed, r.spec.spec_hash()) for r in want]
    with pytest.raises(ValueError, match="sim/os"):
        loadgen.make_fleet_requests(specs, 2, (1,), kind="infer")


def test_session_and_spec_hashes_equal_jax():
    kw = dict(n_steps=16, seed=3, segment=4, nbin=2, n_chains=4, warmup=4,
              n_leapfrog=3, bin_offset=1, data_nbin=5)
    assert SampleSessionSpec(spec=SPEC0, **kw).session_hash() == \
        JaxSession(spec=JSPEC0, **kw).session_hash()
    assert SampleSessionSpec(spec=SPEC1).session_hash() == \
        JaxSession(spec=JSPEC1).session_hash()
    assert resolve_spec_hash(SPEC1, {}) == jresolve(JSPEC1, {})


# ---------------------------------------------------------------------------
# lock order (tests/test_concurrency_regressions.py)
# ---------------------------------------------------------------------------

def _bare_socket_replica() -> SocketReplica:
    """A SocketReplica with just the attributes _die touches: no process,
    no socket."""
    r = SocketReplica.__new__(SocketReplica)
    r.id = "test-replica"
    r._lock = threading.Lock()
    r._pending = {}
    r._raw = set()
    r.alive = True
    r._stderr = None
    return r


def test_socket_replica_die_resolves_futures_outside_lock():
    """set_exception fires done-callbacks synchronously; a callback must
    be able to take the replica lock (fleet failover does)."""
    r = _bare_socket_replica()
    fut: Future = Future()
    r._pending[7] = fut
    lock_free = []
    fut.add_done_callback(
        lambda f: lock_free.append(r._lock.acquire(blocking=False)))
    r._die("injected failure")
    assert lock_free == [True], \
        "done-callback ran while SocketReplica._lock was held"
    r._lock.release()
    assert r.alive is False and r._pending == {}
    with pytest.raises(ReplicaDead):
        fut.result(timeout=0)
    r._die("again")                 # idempotent


def test_socket_replica_close_flips_alive_under_lock_and_fails_pending():
    r = _bare_socket_replica()
    r.sock = SimpleNamespace(close=lambda: None)
    r.proc = None
    fut: Future = Future()
    r._pending[1] = fut
    r.close()
    assert r.alive is False
    with pytest.raises(ReplicaDead):
        fut.result(timeout=0)


def test_pool_close_nodrain_fails_futures_outside_cond():
    import queue as queue_mod

    from fakepta_tpu_torch.serve.scheduler import (_CohortQueue, _Pending,
                                                   _Stats)

    pool = ServePool.__new__(ServePool)
    pool._lock = threading.Lock()
    pool._cond = threading.Condition(pool._lock)
    pool._closed = False
    pool._pending = 1
    pool._stats = _Stats(window=64)
    pool._stream_mgr = None
    q = _CohortQueue(maxlen=4)
    fut: Future = Future()
    req = SimpleNamespace(n=1, kind="emit", deadline_s=None)
    q.append(_Pending(req=req, fut=fut, spec_hash="h", cohort_key="k",
                      t_enq=0.0, deadline=None))
    pool._queues = {"k": q}
    done_thread = threading.Thread(target=lambda: None)
    done_thread.start()
    done_thread.join()
    pool._dispatcher = pool._demux_thread = done_thread
    pool._demux_q = queue_mod.Queue()
    cond_free = []
    fut.add_done_callback(
        lambda f: cond_free.append(pool._cond.acquire(blocking=False)))
    pool.close(drain=False)
    assert cond_free == [True], \
        "future resolved while ServePool._cond was held"
    pool._cond.release()
    from fakepta_tpu_torch.serve import ServeClosed
    with pytest.raises(ServeClosed):
        fut.result(timeout=0)


def test_stream_manager_builds_state_outside_manager_lock(monkeypatch):
    from fakepta_tpu_torch import stream as stream_pkg
    from fakepta_tpu_torch.serve.streams import StreamManager

    mgr = StreamManager(device="cpu")
    lock_free = []

    class ProbeState:
        npsr = 3
        appends = 0
        rolled_back = 0

        def __init__(self, template, **kw):
            got = mgr._lock.acquire(blocking=False)
            lock_free.append(got)
            if got:
                mgr._lock.release()

    class FakeSpec(ArraySpec):
        def parts(self, device=None):
            return None, None

    monkeypatch.setattr(stream_pkg, "StreamState", ProbeState)
    req = SimpleNamespace(stream="s0", spec=FakeSpec(), ecorr_dt=None,
                          watch=None, checkpoint=None)
    slot = mgr._session(req)
    assert lock_free == [True], \
        "StreamState was constructed while StreamManager._lock was held"
    assert isinstance(slot.state, ProbeState)
    assert mgr.stream_names() == ["s0"]
    assert mgr._session(req) is slot


# ---------------------------------------------------------------------------
# the telemetry plane over the fleet (tests/test_telemetry.py:467-540)
# ---------------------------------------------------------------------------

def test_fleet_scrape_feeds_rollup_and_exposition():
    from fakepta_tpu_torch.obs.metrics import SCHEMA_V2
    from fakepta_tpu_torch.serve.cli import _serve_stream

    flt = ServeFleet([LocalReplica(f"h{i}", config=ServeConfig(**CFG),
                                   index=i, device="cpu")
                      for i in range(2)], FleetConfig())
    try:
        flt.enable_health(SCRAPE_HEALTH)
        flt.serve(SimRequest(spec=SPEC0, n=4, seed=1), timeout=T_OUT)

        def _served():
            return max(r.get("requests", 0) for r in
                       flt.telemetry_rollup()["per_replica"].values()
                       or [{}])

        assert _wait_for(_served)
        rollup = flt.telemetry_rollup()
        assert rollup["schema"] == SCHEMA_V2
        assert set(rollup["per_replica"]) == {"h0", "h1"}
        assert rollup["fleet"]["replicas"] == 2
        assert flt.slo_summary().get("fleet_scrapes", 0) >= 2
        text = flt.metrics_text()
        assert "fakepta_fleet_replicas 2" in text
        assert 'fakepta_up{replica="h0"}' in text
        pool = flt.replicas["h0"].pool
        assert pool.metrics_text().startswith("# HELP")
        # the stats protocol reply: the JAX keys plus the kernel facts
        out = []
        lines = [json.dumps({"id": i, "kind": k}) for i, k in
                 enumerate(("ping", "stats", "telemetry", "metrics"))]
        assert _serve_stream(pool, lines, out.append, SPEC0, "summary") == 0
        replies = {r["id"]: r for r in map(json.loads, out)}
        assert replies[0]["pong"] and all(r["ok"] for r in replies.values())
        assert {"stats", "health", "pool", "streams",
                "kernels"} <= set(replies[1])
        assert replies[1]["kernels"]["nvcc_starts"] == 0
        assert {"slo", "pool", "live"} <= set(replies[2]["telemetry"])
    finally:
        flt.close()


# ---------------------------------------------------------------------------
# served streams (tests/test_stream.py:382-464)
# ---------------------------------------------------------------------------

STREAM_KW = dict(npsr=4, ntoa=40, tspan_years=3.0, n_red=3, n_dm=3,
                 gwb_ncomp=3)
STREAM_SPEC = ArraySpec(**STREAM_KW)
JSTREAM_SPEC = JaxSpec(**STREAM_KW)
TSPAN_S = 3.0 * 365.25 * 86400.0


def _append(cls, spec, stream="s0", width=4, seed=9, t_hi=0.9, **kw):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.0, t_hi * TSPAN_S, (4, width)), axis=1)
    return cls(stream=stream, toas=t,
               residuals=rng.normal(0.0, 1e-7, (4, width)), spec=spec, **kw)


@pytest.fixture(scope="module")
def served_streams():
    """Three appends and a stats read through a port pool and a JAX pool,
    the second open-time spec ignored as a reopen."""
    from fakepta_tpu.serve import StreamRequest as JaxStream

    out = {}
    for name, pool, cls, stream_cls, spec in (
            ("port", ServePool(device="cpu"), AppendRequest, StreamRequest,
             STREAM_SPEC),
            ("jax", JaxPool(mesh=jax_mesh(jax.devices()[:1])), JaxAppend,
             JaxStream, JSTREAM_SPEC)):
        try:
            infos = [pool.submit(_append(cls, spec, seed=s, ecorr_dt=2e6,
                                         watch="hd")).result(timeout=T_OUT)
                     for s in (9, 10, 11)]
            stats = pool.submit(stream_cls(stream="s0")).result(
                timeout=T_OUT)
            state = pool._stream_mgr._streams["s0"].state
            out[name] = {"infos": infos, "stats": stats,
                         "moments": [np.asarray(m) if not hasattr(
                             m, "numpy") else m.numpy()
                             for m in state.moments()],
                         "summary": pool.stream_summary()}
            if name == "port":
                with pytest.raises(ServeError):
                    pool.submit(stream_cls(stream="nope"))
        finally:
            pool.close()
    return out


def test_serve_pool_executes_stream_requests(served_streams):
    from fakepta_tpu_torch.serve.streams import STREAM_PAYLOAD_SCHEMA

    got = served_streams["port"]
    r1, r2, r3 = got["infos"]
    assert r1["kind"] == "append" and \
        r1["payload_schema"] == STREAM_PAYLOAD_SCHEMA
    assert r2["n_toas"] == r1["n_toas"] + 16 and r3["n_toas"] == 48
    assert r2["recompiles"] == 0
    assert got["stats"]["kind"] == "stream" and got["stats"]["appends"] == 3
    assert got["summary"]["s0"]["appends"] == 3
    assert got["summary"]["s0"]["toas"] == 48
    want = served_streams["jax"]
    for key in ("n_toas", "kind", "payload_schema", "stream"):
        assert [i[key] for i in got["infos"]] == \
            [i[key] for i in want["infos"]]
    assert set(got["summary"]["s0"]) == set(want["summary"]["s0"])


def test_served_stream_moments_match_jax(served_streams):
    for g, w in zip(served_streams["port"]["moments"],
                    served_streams["jax"]["moments"]):
        np.testing.assert_allclose(g, w, rtol=1e-10,
                                   atol=1e-10 * max(np.abs(w).max(), 1e-300))
    for key in ("snr", "amp2"):
        g = served_streams["port"]["stats"].get(key)
        w = served_streams["jax"]["stats"].get(key)
        assert (g is None) == (w is None), key
        if w is not None:
            np.testing.assert_allclose(g, w, rtol=1e-9)


def test_fleet_routes_streams_with_affinity():
    flt = ServeFleet([LocalReplica(f"r{i}", config=ServeConfig(**CFG),
                                   index=i, device="cpu")
                      for i in range(2)], FleetConfig())
    try:
        res = [flt.serve(_append(AppendRequest, STREAM_SPEC, seed=s),
                         timeout=T_OUT) for s in (11, 12, 13)]
        owners = {r["replica"] for r in res}
        assert len(owners) == 1 and res[-1]["n_toas"] == 48
        stats = flt.serve(StreamRequest(stream="s0"), timeout=T_OUT)
        assert stats["replica"] in owners and stats["appends"] == 3
        other = (set(flt.replicas) - owners).pop()
        assert flt.replicas[other].pool.stream_summary() == {}
    finally:
        flt.close()


def test_cutover_under_concurrent_appends_loses_none():
    """A cutover onto a wider template while another thread appends:
    every append lands (on the old state before the fence or the new one
    after it), the TOA count is conserved and the new state's moments
    equal a fresh restage."""
    wide = dataclasses.replace(STREAM_SPEC, tspan_years=4.0)
    pool = ServePool(device="cpu")
    try:
        pool.serve(_append(AppendRequest, STREAM_SPEC, seed=1))
        n_more, done = 6, []

        def appender():
            for s in range(n_more):
                done.append(pool.serve(_append(
                    AppendRequest, None, seed=100 + s)))

        t = threading.Thread(target=appender)
        t.start()
        info = pool.cutover_stream("s0", wide)
        t.join(60)
        assert not t.is_alive() and len(done) == n_more
        assert info["new_tspan_s"] > info["old_tspan_s"]
        stats = pool.serve(StreamRequest(stream="s0"))
        assert stats["n_toas"] == 16 * (1 + n_more)
        state = pool._stream_mgr._streams["s0"].state
        assert state.tspan == info["new_tspan_s"]
        for g, w in zip(state.moments(), state.restage_moments()):
            g, w = g.numpy(), w.numpy()
            np.testing.assert_allclose(g, w, rtol=1e-10,
                                       atol=1e-10 * max(np.abs(w).max(),
                                                        1e-300))
        with pytest.raises(ServeError, match="not open"):
            pool.cutover_stream("nope", wide)
    finally:
        pool.close()


def test_failover_into_a_saturated_sibling_loses_nothing():
    """Both replicas at the router's in-flight bound (the second request
    spilled to the sibling), then the owner dies: its request fails over
    past the bound, since it was admitted already, and both requests
    complete bit for bit their solo runs. (The JAX router fails it with
    ServeBusy: a lost request.)"""
    cfg = ServeConfig(buckets=(8,), coalesce_window_s=0.5)
    flt = ServeFleet([LocalReplica(f"k{i}", config=cfg, index=i,
                                   device="cpu") for i in range(2)],
                     FleetConfig(max_inflight_per_replica=1))
    try:
        owner = flt.ring.owner(SPEC0.spec_hash())
        f1 = flt.submit(SimRequest(spec=SPEC0, n=3, seed=41))
        f2 = flt.submit(SimRequest(spec=SPEC0, n=2, seed=42))
        assert flt.slo_summary()["fleet_spillovers"] == 1
        flt._mark_dead(owner, "test kill")
        flt.replicas[owner].kill()
        r1, r2 = f1.result(timeout=T_OUT), f2.result(timeout=T_OUT)
        assert r1.failovers == 1 and r1.replica != owner
        assert r2.failovers == 0 and r2.replica == r1.replica
        sim = SPEC0.build(device="cpu")
        for r, (seed, n) in ((r1, (41, 3)), (r2, (42, 2))):
            alone = sim.run(r.bucket, chunk=r.bucket, lanes=[(seed, n)],
                            pipeline_depth=0)
            assert np.array_equal(r.curves, alone["curves"][:n])
        slo = flt.slo_summary()
        assert slo["fleet_failed"] == 0 and slo["fleet_rejected"] == 0
    finally:
        flt.close()


def test_fleet_loadgen_row_has_the_jax_keys(fleets):
    """The same small workload through each package's fleet load
    generator, on the module's fleets (their simulators warm): the port's
    row carries every key of the JAX row, plus the replicas' devices (a
    prebuilt fleet has no start-up seconds to report)."""
    kw = dict(n_requests=4, sizes=(1,), n_specs=1, seed=0, verify=0)
    want = jloadgen.run_fleet_loadgen(spec=JSPEC0, fleet=fleets["jfleet"],
                                      config=JaxConfig(**CFG), **kw)
    got = loadgen.run_fleet_loadgen(spec=SPEC0, fleet=fleets["fleet"],
                                    config=ServeConfig(**CFG),
                                    device="cpu", **kw)
    assert set(got) - set(want) == {"fleet_ready_s", "fleet_devices"}
    assert set(want) <= set(got) and got["fleet_ready_s"] == {}
    assert got["fleet_transport"] == want["fleet_transport"] == "inproc"
    assert got["fleet_requests"] == want["fleet_requests"] == 4
