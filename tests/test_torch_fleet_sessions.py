"""The port's fleet sampling sessions and fleet load generators
(``serve/fleet.py::SamplingSession``, ``sample.run_factorized_sessions``,
``serve/loadgen.py``), on the CPU with in-process replicas.

- a :class:`SamplingSession` whose owner is killed mid-run
  (``sample.segment`` kill) migrates to the ring sibling and resumes from
  the segment-boundary checkpoint: chains and streamed segments bit for
  bit the uninterrupted run (tests/test_fleet.py:307);
- a lane session's staged data (the moments its run samples) equals the
  JAX package's ``build_session_run`` path within 1e-10;
- ``run_factorized_sessions`` over two replicas equals the port's own
  :class:`FactorizedRun` lanes (same ``lane_seed`` s) bit for bit;
- ``run_fleet_loadgen(transport="inproc")`` with a mid-load kill and
  ``run_elastic_loadgen`` (wedge, kill, join) at tiny sizes: rows with the
  JAX rows' keys, nothing lost, no timeout, every failed-over response
  bit-verified inside the generators; ``measure_telemetry_overhead``.
"""

import dataclasses

import numpy as np
import pytest

from fakepta_tpu.serve import fleet as jfleet
from fakepta_tpu.serve.spec import ArraySpec as JaxSpec
from fakepta_tpu_torch import faults
from fakepta_tpu_torch.sample import FactorizedRun, run_factorized_sessions
from fakepta_tpu_torch.serve import (ArraySpec, FleetConfig, LocalReplica,
                                     SampleSessionSpec, ServeConfig,
                                     ServeFleet, run_elastic_loadgen,
                                     run_fleet_loadgen)
from fakepta_tpu_torch.serve.fleet import build_session_run
from fakepta_tpu_torch.serve.loadgen import measure_telemetry_overhead

SPEC_KW = dict(npsr=4, ntoa=32, n_red=3, n_dm=3, gwb_ncomp=3)
SPEC0 = ArraySpec(data_seed=100, **SPEC_KW)
CFG = ServeConfig(buckets=(8,), coalesce_window_s=0.005)
SESSION = dict(n_steps=16, seed=3, segment=4, nbin=2, n_chains=4, warmup=4,
               thin=1, n_leapfrog=3)


def _fleet(prefix="s"):
    return ServeFleet([LocalReplica(f"{prefix}{i}", config=CFG, index=i,
                                    device="cpu") for i in range(2)],
                      FleetConfig())


def test_sampling_session_migrates_bit_exactly(tmp_path):
    flt = _fleet()
    sess = SampleSessionSpec(spec=SPEC0, **SESSION)
    try:
        owner = flt.ring.owner(sess.session_hash())
        ref = flt.replicas[owner].sampling_run(sess).run(
            sess.n_steps, seed=sess.seed, segment=sess.segment,
            pipeline_depth=0)
        streamed = {}
        plan = faults.FaultPlan(
            [faults.FaultSpec("sample.segment", "kill", at=(2,))])
        session = flt.start_session(sess, tmp_path / "ck")
        assert session.replica_id == owner
        with faults.inject(plan):
            out = session.run(on_segment=lambda idx, arr: streamed.setdefault(
                idx, np.array(arr)))
        assert out["session"]["migrations"] == 1
        assert out["session"]["replica"] != owner
        assert not flt.replicas[owner].alive
        np.testing.assert_array_equal(out["theta"], ref["theta"])
        kept = np.concatenate([streamed[i] for i in sorted(streamed)])
        np.testing.assert_array_equal(kept, ref["theta"])
    finally:
        flt.close()


def test_session_run_stages_as_jax_does():
    """A factorized lane session's one construction path on each side:
    the parent model's synthesized data, its staged moments and the lane
    window's marginalized moments (what the run samples) equal the JAX
    package's within 1e-10 of each array's scale (host float64 algebra on
    the spec's float32 batch: 2.7e-12 measured)."""
    from fakepta_tpu.infer import model as jmodel
    from fakepta_tpu.sample.factorized import \
        marginalized_window_moments as jwindow
    from fakepta_tpu.sample.run import stage_moments as jstage
    from fakepta_tpu.sample.run import synthesize_residuals as jsynth
    from fakepta_tpu_torch.parallel.mesh import make_mesh

    kw = dict(SESSION, nbin=2, bin_offset=1, data_nbin=3)
    run = build_session_run(SampleSessionSpec(spec=SPEC0, **kw),
                            make_mesh(["cpu"]))
    jsess = jfleet.SampleSessionSpec(spec=JaxSpec(data_seed=100, **SPEC_KW),
                                     **kw)
    batch, _ = jsess.spec.parts()
    parent = jmodel.build(jsess._model(3), batch)
    truth = parent.theta_from_unit(np.full(parent.D, 0.5))
    mom = jstage(parent, batch, jsynth(parent, batch, truth,
                                       jsess.data_seed))
    want = jwindow(parent, batch, mom, 1, 3)
    for g, w in zip(run._mom64, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-10,
                                   atol=1e-10 * max(np.abs(w).max(), 1e-300))
    assert run.compiled.D == 2


def test_factorized_sessions_equal_the_local_factorized_run(tmp_path):
    """Bin lanes routed over a two-replica fleet equal the port's own
    FactorizedRun lanes (the same data, the same lane seeds) bit for bit,
    recombined in the parent's theta slots."""
    from fakepta_tpu_torch.sample import SampleSpec

    sess = SampleSessionSpec(spec=SPEC0, n_steps=8, seed=5, segment=4,
                             nbin=4, n_chains=4, warmup=4, n_leapfrog=3)
    flt = _fleet("f")
    try:
        out = run_factorized_sessions(flt, sess, tmp_path / "fs",
                                      lane_bins=2)
    finally:
        flt.close()
    assert out["summary"]["fs_lane_count"] == 2
    assert [s["lo"] for s in out["sessions"]] == [0, 2]
    batch, _ = SPEC0.parts(device="cpu")
    spec = SampleSpec(model=sess._model(4), n_chains=4, n_temps=1,
                      warmup=4, thin=1, step_size=0.3, n_leapfrog=3)
    local = FactorizedRun(batch, spec, lane_bins=2,
                          data_seed=sess.data_seed, device="cpu")
    want = local.run(8, seed=5, segment=4, pipeline_depth=0)
    for got_lane, want_lane in zip(out["lanes"], want["lanes"]):
        np.testing.assert_array_equal(got_lane["theta"],
                                      want_lane["theta"])
    # the parent's theta slots: the lanes' free bins, the pinned
    # components (red, dm) are marginalized out of every lane
    free = [i for i, n in enumerate(local.parent.param_names)
            if "rho" in n]
    np.testing.assert_array_equal(out["theta"], want["theta"][..., free])


def test_fleet_loadgen_inproc_row_loses_nothing():
    row = run_fleet_loadgen(
        spec=SPEC0, fleet=2, transport="inproc", n_requests=16,
        sizes=(1, 2), n_specs=3, seed=0, verify=2, baseline=True,
        kill_one_at=0.5, config=CFG, device="cpu")
    assert row["fleet_lost_requests"] == 0 and row["fleet_timeouts"] == 0
    assert row["fleet_requests"] == 16 and row["fleet_replica_deaths"] == 1
    assert row["fleet_steady_compiles"] == 0
    assert row["fleet_verified"] >= 2
    assert row["fleet_transport"] == "inproc"
    assert row["fleet_speedup_x"] > 0 and row["fleet_devices"] == ["cpu"]
    assert row["fleet_killed_replica"] in ("r0", "r1")
    assert {"fleet_solo_qps", "fleet_solo_p50_ms",
            "fleet_verified_failover"} <= set(row)


def test_elastic_loadgen_wedge_kill_join_row():
    row = run_elastic_loadgen(
        spec=SPEC0, n_replicas=3, transport="inproc", n_requests=24,
        sizes=(1, 2), n_specs=3, verify=2, config=CFG, device="cpu")
    assert row["fleet_lost_requests"] == 0 and row["fleet_timeouts"] == 0
    assert row["fleet_joins"] >= 1 and row["scale_events"] >= 1
    assert row["fleet_join_steady_compiles"] == 0
    assert row["fleet_wedge_state"] in ("suspect", "wedged")
    assert row["fleet_breaker_opens"] >= 1
    assert row["fleet_killed_replica"] != row["fleet_wedged_replica"]
    assert {"fleet_scrapes", "fleet_alerts", "fleet_verified",
            "fleet_verified_failover"} <= set(row)


def test_telemetry_overhead_row():
    row = measure_telemetry_overhead(spec=SPEC0, n_requests=8, sizes=(1,),
                                     n_specs=2, config=CFG, rounds=1,
                                     device="cpu")
    assert set(row) == {"telemetry_qps_on", "telemetry_qps_off",
                        "telemetry_overhead_frac"}
    assert row["telemetry_qps_on"] > 0 and row["telemetry_qps_off"] > 0
    assert 0.0 <= row["telemetry_overhead_frac"] < 1.0


def test_compile_cache_dir_is_refused_but_none_accepted(tmp_path):
    with pytest.raises(NotImplementedError, match="build directory"):
        LocalReplica("x", device="cpu", compile_cache_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="build directory"):
        run_fleet_loadgen(spec=SPEC0, fleet=1, transport="inproc",
                          compile_cache_dir=str(tmp_path), device="cpu")
    r = LocalReplica("y", device="cpu", compile_cache_dir=None)
    try:
        assert r.device_ids() == ("cpu",)
    finally:
        r.close()
    with pytest.raises(ValueError, match="mesh"):
        run_fleet_loadgen(spec=dataclasses.replace(SPEC0), fleet=1,
                          transport="process", mesh=object())
