"""The port's serving layer (``fakepta_tpu_torch.serve``: warm pool,
scheduler, load generator) against the JAX package's, on the CPU.

One module-scoped fixture puts the same phases through a JAX pool and a
port pool (``device="cpu"``) at tests/test_serve.py's scale (6 pulsars x
48 TOAs, buckets 8 and 16): two requests coalesced into one bucket-8
dispatch, the first served alone, the first again in a bucket-16 cohort,
a detection request with its null stream, and a registered tenant. Held:

- within the port: coalesced equals alone at the same bucket bit for bit,
  the tenant equals the spec, the OS request equals its lane alone, the
  cross-bucket bound is the JAX test's (rtol 1e-5, 1e-7 of the scale);
- against JAX: the port's default served path (``fused``, bf16 operands)
  within the bf16 bound (1e-2 of the curve scale; OS amp2 1e-2 of
  max|amp2|), and a registered ``einsum`` simulator within 1e-5 of the
  curve scale (the JAX pool serves XLA f32);
- the SLO summary's keys and the ``metrics`` exposition's line set are
  the JAX pool's; zero steady builds.
"""

import dataclasses

import jax
import numpy as np
import pytest

from fakepta_tpu.parallel.mesh import make_mesh as jax_mesh
from fakepta_tpu.serve import OSRequest as JaxOS
from fakepta_tpu.serve import ServeConfig as JaxConfig
from fakepta_tpu.serve import ServePool as JaxPool
from fakepta_tpu.serve import SimRequest as JaxSim
from fakepta_tpu.serve.spec import ArraySpec as JaxSpec
from fakepta_tpu_torch import faults
from fakepta_tpu_torch.obs import telemetry
from fakepta_tpu_torch.parallel.montecarlo import EnsembleSimulator
from fakepta_tpu_torch.serve import (ArraySpec, AppendRequest, OSRequest,
                                     ServeBusy, ServeConfig, ServeError,
                                     ServePool, ServeTimeout, SimRequest,
                                     StreamRequest, run_loadgen)

SPEC_KW = dict(npsr=6, ntoa=48, n_red=4, n_dm=4, gwb_ncomp=4)
SPEC = ArraySpec(**SPEC_KW)
JSPEC = JaxSpec(**SPEC_KW)
CONFIG = dict(buckets=(8, 16), coalesce_window_s=0.05, max_queue_depth=32)
TOL = {"f32": 1e-5, "bf16": 1e-2}
T_OUT = 300


def _phases(pool, spec, sim_cls, os_cls):
    """The served cases, each phase submitted together and waited on."""
    out = {}
    fa = pool.submit(sim_cls(spec=spec, n=5, seed=11))
    fb = pool.submit(sim_cls(spec=spec, n=3, seed=22))
    out["A"], out["B"] = fa.result(timeout=T_OUT), fb.result(timeout=T_OUT)
    out["A_alone"] = pool.serve(sim_cls(spec=spec, n=5, seed=11),
                                timeout=T_OUT)
    fa2 = pool.submit(sim_cls(spec=spec, n=5, seed=11))
    fc = pool.submit(sim_cls(spec=spec, n=9, seed=33))
    out["A_b16"], out["C"] = (fa2.result(timeout=T_OUT),
                              fc.result(timeout=T_OUT))
    out["OS"] = pool.serve(os_cls(spec=spec, n=4, seed=44, null=True),
                           timeout=T_OUT)
    entry = pool._pool.get(spec.spec_hash(), spec)
    out["entry"] = entry
    pool.register("tenant", entry.sim)
    out["named"] = pool.serve(sim_cls(spec="tenant", n=3, seed=22),
                              timeout=T_OUT)
    return out


@pytest.fixture(scope="module")
def served():
    jpool = JaxPool(mesh=jax_mesh(jax.devices()[:1]),
                    config=JaxConfig(**CONFIG))
    pool = ServePool(device="cpu", config=ServeConfig(**CONFIG))
    try:
        jout = _phases(jpool, JSPEC, JaxSim, JaxOS)
        out = _phases(pool, SPEC, SimRequest, OSRequest)
        out["slo"], jout["slo"] = pool.slo_summary(), jpool.slo_summary()
        # the exposition of one warm request (the first phases' latencies
        # hold the JAX pool's compiles, whose p99 may fire an alert), with
        # other tests' live gauges cleared in both packages
        from fakepta_tpu.obs import telemetry as jtelemetry
        for p, sim_cls, spec in ((pool, SimRequest, SPEC),
                                 (jpool, JaxSim, JSPEC)):
            p.reset_stats()
            p.serve(sim_cls(spec=spec, n=5, seed=11), timeout=T_OUT)
        jtelemetry.clear_live_gauges()
        telemetry.clear_live_gauges()
        out["metrics"], jout["metrics"] = (pool.metrics_text(),
                                           jpool.metrics_text())
        # a registered einsum simulator: the JAX pool's f32 arithmetic
        batch, gwb = SPEC.parts(device="cpu")
        pool.register("einsum", EnsembleSimulator(
            batch, gwb=gwb, nbins=SPEC.nbins, stat_path="einsum",
            device="cpu"))
        fa = pool.submit(SimRequest(spec="einsum", n=5, seed=11))
        fb = pool.submit(SimRequest(spec="einsum", n=3, seed=22))
        out["E_A"], out["E_B"] = (fa.result(timeout=T_OUT),
                                  fb.result(timeout=T_OUT))
        out["E_C"] = pool.serve(SimRequest(spec="einsum", n=9, seed=33),
                                timeout=T_OUT)
        yield {"port": out, "jax": jout, "pool": pool}
    finally:
        pool.close()
        jpool.close()


def _close(got, want, tol, what):
    scale = np.abs(want.curves).max()
    np.testing.assert_allclose(got.curves, want.curves, rtol=0,
                               atol=tol * scale, err_msg=what)
    np.testing.assert_allclose(got.autos, want.autos, rtol=tol,
                               err_msg=what)


def test_coalesced_request_is_bit_identical_to_alone(served):
    """The RNG-lane contract: a coalesced response equals the same request
    served alone at the same bucket bit for bit, and its solo run(n, seed)
    within the path's bound; the cohort facts are the JAX pool's."""
    out, jout = served["port"], served["jax"]
    sim = out["entry"].sim
    for name, seed, n in (("A", 11, 5), ("B", 22, 3)):
        alone = sim.run(8, chunk=8, lanes=[(seed, n)], pipeline_depth=0)
        assert np.array_equal(out[name].curves, alone["curves"][:n])
        assert np.array_equal(out[name].autos, alone["autos"][:n])
    solo = sim.run(5, seed=11, chunk=5, pipeline_depth=0)
    assert solo["statistic_path"] == "fused" and solo["precision"] == "bf16"
    _close(out["A"], type(out["A"])(solo["curves"], solo["autos"], None),
           TOL["bf16"], "A vs its solo run")
    for name in ("A", "B", "A_alone", "A_b16", "C", "OS", "named"):
        for fld in ("cohort_requests", "bucket", "pad_waste_frac"):
            assert getattr(out[name], fld) == getattr(jout[name], fld), \
                (name, fld)


def test_cohort_pad_and_bucket_invariance(served):
    """Alone at the same bucket: bit for bit; a bucket-16 cohort within the
    JAX test's cross-bucket bound (the plain statistic's order does not
    depend on the realization count R here: it is bit-equal)."""
    out = served["port"]
    assert np.array_equal(out["A_alone"].curves, out["A"].curves)
    assert np.array_equal(out["A_alone"].autos, out["A"].autos)
    assert out["A_alone"].cohort_requests == 1
    assert out["A_b16"].bucket == 16
    scale = np.abs(out["A"].curves).max()
    np.testing.assert_allclose(out["A_b16"].curves, out["A"].curves,
                               rtol=1e-5, atol=1e-7 * scale)
    np.testing.assert_allclose(out["A_b16"].autos, out["A"].autos,
                               rtol=1e-5)


def test_registered_tenant_serves_identically(served):
    out = served["port"]
    assert np.array_equal(out["named"].curves, out["B"].curves)
    assert np.array_equal(out["named"].autos, out["B"].autos)


def test_os_request_with_null_is_its_own_lane(served):
    """A detection request's statistics, its paired-null calibration
    included, come from its own slice: equal to the request alone at the
    same bucket, p-values from its own 4-realization null sample, and
    within the bf16 bound of the JAX pool's."""
    from fakepta_tpu_torch.detect import OSSpec

    out, jout = served["port"], served["jax"]
    alone = out["entry"].sim.run(8, chunk=8, lanes=[(44, 4)],
                                 pipeline_depth=0,
                                 os=OSSpec(orf="hd", null=True))
    got = out["OS"].os["stats"]["hd"]
    want = alone["os"]["stats"]["hd"]
    np.testing.assert_array_equal(got["amp2"], want["amp2"][:4])
    np.testing.assert_array_equal(got["null_amp2"], want["null_amp2"][:4])
    rank = np.searchsorted(np.sort(got["null_amp2"]), got["amp2"],
                           side="left")
    np.testing.assert_allclose(got["p_value"], (1.0 + 4 - rank) / 5.0)
    jgot = jout["OS"].os["stats"]["hd"]
    assert set(got) == set(jgot)
    for key in ("amp2", "null_amp2"):
        scale = np.abs(jgot["amp2"]).max()
        np.testing.assert_allclose(got[key], jgot[key], rtol=0,
                                   atol=TOL["bf16"] * scale)


@pytest.mark.parametrize("name", ["A", "B", "A_alone", "A_b16", "C",
                                  "named"])
def test_port_pool_within_the_bf16_bound_of_jax(served, name):
    _close(served["port"][name], served["jax"][name], TOL["bf16"], name)


@pytest.mark.parametrize("name", ["A", "B", "C"])
def test_registered_einsum_sim_within_f32_of_jax(served, name):
    """The port's einsum path is the JAX pool's f32 arithmetic: within
    1e-5 of the curve scale (the engine's f32 bound)."""
    _close(served["port"][f"E_{name}"], served["jax"][name], TOL["f32"],
           name)


def test_zero_steady_compiles_and_slo_keys_equal_jax(served):
    slo, jslo = served["port"]["slo"], served["jax"]["slo"]
    assert set(slo) == set(jslo)
    assert slo["serve_retraces"] == 0
    assert slo["serve_steady_compiles"] == 0
    assert slo["serve_requests"] == jslo["serve_requests"] == 7
    assert slo["serve_dispatches"] == jslo["serve_dispatches"]
    assert slo["coalesce_factor"] == jslo["coalesce_factor"] > 1.0
    assert slo["pad_waste_frac"] == jslo["pad_waste_frac"]


def _strip_values(text):
    return {line.rsplit(" ", 1)[0] if not line.startswith("#") else line
            for line in text.splitlines()}


def test_metrics_text_line_set_equals_jax(served):
    """The Prometheus exposition names the same families, samples and
    labels (spec hashes included: one ArraySpec hashes alike in both)."""
    got, want = served["port"]["metrics"], served["jax"]["metrics"]
    assert _strip_values(got) == _strip_values(want)
    assert "fakepta_alert_active" not in got
    assert 'fakepta_up{replica="self"} 1' in got


def test_slo_report_roundtrips_through_obs(served, tmp_path):
    """The pool's report is an obs artifact both packages load."""
    from fakepta_tpu.obs import RunReport as JaxReport
    from fakepta_tpu_torch.obs.report import RunReport

    path = tmp_path / "serve.jsonl"
    served["pool"].save_report(path)
    for rep in (RunReport.load(path), JaxReport.load(path)):
        assert rep.meta["kind"] == "serve"
        assert rep.meta["platform"] == "cpu"
        assert rep.summary()["serve_requests"] >= 4
        assert {"request", "serve_dispatch"} <= {e.get("name")
                                                for e in rep.timeline}


def test_backpressure_deadline_and_validation():
    """Admission control without dispatching: a 30 s coalesce window
    holds requests queued. The JAX test races its two 0.05 s deadlines
    (the window closes at the first one, and the second, a few
    microseconds later, is dispatched if the dispatcher wakes in between);
    here the test holds the pool's lock from before the first deadline
    until after the second, so the dispatcher finds both expired. The
    busy check runs with 3 s to spare."""
    import time

    pool = ServePool(device="cpu",
                     config=ServeConfig(buckets=(8,), max_queue_depth=2,
                                        coalesce_window_s=30.0))
    try:
        t0 = time.monotonic()
        f1 = pool.submit(SimRequest(spec=SPEC, n=2, seed=1, deadline_s=3.0))
        f2 = pool.submit(SimRequest(spec=SPEC, n=2, seed=2, deadline_s=3.0))
        with pytest.raises(ServeBusy) as busy:
            pool.submit(SimRequest(spec=SPEC, n=2, seed=3))
        assert busy.value.retry_after_s > 0
        with pool._lock:
            assert time.monotonic() - t0 < 3.0, "the margin was spent"
            # none of these takes the pool's lock: they fail before it
            with pytest.raises(ValueError, match="bucket ladder"):
                pool.submit(SimRequest(spec=SPEC, n=64, seed=4))
            with pytest.raises(ServeError, match="unknown registered spec"):
                pool.submit(SimRequest(spec="nope", n=2, seed=5))
            time.sleep(max(3.5 - (time.monotonic() - t0), 0.0))
        # the stream kinds bypass the queue (and take the pool's lock): a
        # stream no append has opened is an admission error
        for req in (AppendRequest(stream="s"), StreamRequest(stream="s")):
            with pytest.raises(ServeError, match="not open"):
                pool.submit(req)
        with pytest.raises(ServeTimeout):
            f1.result(timeout=60)
        with pytest.raises(ServeTimeout):
            f2.result(timeout=60)
        slo = pool.slo_summary()
        assert slo["serve_rejected"] == 1
        assert slo["serve_deadline_cancelled"] == 2
        assert slo["serve_dispatches"] == 0
    finally:
        pool.close()


def test_serve_dispatch_fault_kinds(served):
    """The ``serve.dispatch`` site: a transient failure is retried, a
    poisoned output evicts the entry and re-dispatches once, each response
    bit-identical to the unfaulted one; a kernel failure (the port's
    launch error class) and a fatal one fail the cohort, never retried."""
    sim = served["port"]["entry"].sim
    want = served["port"]["B"]
    pool = ServePool(device="cpu", config=ServeConfig(
        buckets=(8,), retry_backoff_s=0.0, prewarm_buckets=(8,)))
    spec_hash = pool.register("t", sim)
    try:
        # registration warmed the configured prewarm ladder
        assert pool.warm_summary()["specs"][spec_hash]["warm_buckets"] == 1
        for kind, counter in (("transient", "serve_dispatch_retries"),
                              ("poison", "serve_evictions")):
            pool.reset_stats()
            plan = faults.FaultPlan([faults.FaultSpec("serve.dispatch",
                                                      kind)])
            with faults.inject(plan):
                got = pool.serve(SimRequest(spec="t", n=3, seed=22),
                                 timeout=T_OUT)
            assert plan.fired == [("serve.dispatch", kind, 0)]
            assert pool.slo_summary()[counter] == 1
            assert np.array_equal(got.curves, want.curves)
        for kind in ("degrade", "fatal"):
            pool.reset_stats()
            plan = faults.FaultPlan([faults.FaultSpec("serve.dispatch",
                                                      kind)])
            with faults.inject(plan):
                with pytest.raises(ServeError, match="dispatch failed"):
                    pool.serve(SimRequest(spec="t", n=3, seed=22),
                               timeout=T_OUT)
            slo = pool.slo_summary()
            assert slo["serve_dispatch_retries"] == 0
            assert slo["serve_failed"] == 1
    finally:
        pool.close()


def test_run_loadgen_verifies_on_a_tiny_spec(served):
    """The one-pool load generator: every request resolves, the verified
    responses hold both layers of the lane contract, and the row carries
    the JAX row's keys."""
    spec = ArraySpec(npsr=4, ntoa=32, n_red=3, n_dm=3, gwb_ncomp=3)
    row = run_loadgen(spec, n_requests=8, sizes=(1, 2, 3), verify=2,
                      baseline=True, device="cpu",
                      config=ServeConfig(buckets=(4, 8),
                                         coalesce_window_s=0.01))
    want = set(served["jax"]["slo"]) | {
        "serve_kind", "serve_verified", "serve_serial_qps_per_chip",
        "serve_speedup_x"}
    assert want <= set(row)
    assert set(row) - want == {"serve_warm_s_by_bucket", "serve_verify_err"}
    assert row["serve_requests"] == 8 and row["serve_failed"] == 0
    assert row["serve_verified"] == 2
    assert row["serve_steady_compiles"] == 0
    assert set(row["serve_warm_s_by_bucket"]) == {"4", "8"}
    # fleet= hands the same request list to a fleet (here a prebuilt one
    # of one in-process replica)
    from fakepta_tpu_torch.serve import LocalReplica, ServeFleet
    flt = ServeFleet([LocalReplica("r0", device="cpu",
                                   config=ServeConfig(buckets=(4, 8)))])
    try:
        frow = run_loadgen(spec, fleet=flt, n_requests=4, sizes=(1, 2),
                           n_specs=1, verify=1, device="cpu",
                           config=ServeConfig(buckets=(4, 8)))
    finally:
        flt.close()
    assert frow["fleet_transport"] == "inproc"
    assert frow["fleet_requests"] == 4 and frow["fleet_lost_requests"] == 0


def test_make_requests_equals_jax():
    from fakepta_tpu.serve.loadgen import make_requests as jax_make
    from fakepta_tpu_torch.serve.loadgen import DEFAULT_SIZES, make_requests

    for kind in ("sim", "os"):
        got = make_requests(SPEC, 12, DEFAULT_SIZES, kind=kind, seed=3)
        want = jax_make(JSPEC, 12, DEFAULT_SIZES, kind=kind, seed=3)
        assert [dataclasses.astuple(r)[1:] for r in got] == \
            [dataclasses.astuple(r)[1:] for r in want]
        assert [r.lane_token() for r in got] == \
            [r.lane_token() for r in want]


def test_tuned_ladder_replaces_the_hand_set_one(monkeypatch):
    """``tuned=True`` takes the store's ladder for the pool's own devices
    (the real-axis multiples of it) and makes it the prewarm set; a store
    miss keeps the hand-set ladder with a flight-recorder note."""
    from fakepta_tpu_torch import tune
    from fakepta_tpu_torch.obs import flightrec

    asked = []

    def resolve(store=None, devices=None):
        asked.append([tune.fingerprint(devices).platform])
        return ladder

    monkeypatch.setattr(tune, "resolve_buckets", resolve)
    ladder = (4, 12, 8)
    pool = ServePool(device="cpu", tuned=True)
    try:
        assert pool.buckets == (4, 8, 12)
        assert pool.config.prewarm_buckets == (4, 12, 8)
        assert asked == [["cpu"]]         # the mesh's devices, not the card
    finally:
        pool.close()
    ladder = None
    flightrec.clear()
    pool = ServePool(device="cpu", tuned=True)
    try:
        assert pool.buckets == ServeConfig().buckets
        assert "serve_tuned_miss" in [e["name"]
                                      for e in flightrec.snapshot()]
    finally:
        pool.close()
