"""The port's chaos harness and recovery policy against the JAX package's,
on the CPU.

The contract of ``fakepta_tpu_torch.faults``: every injected fault either
recovers (outputs bit-identical to the unfaulted run, or within the path's
bound when a degradation changed the path) or fails loudly with a
flight-recorder dump. The engine lanes are the JAX chaos matrix's
(tests/test_faults.py), on the same batch, held to the JAX engine's XLA run
within the port's engine bounds: 1e-5 of the curve scale at f32 (the
port's draws equal the JAX draws to a few float32 ULP) and 1e-2 under bf16
operands. The triage is held label for label against the JAX package's
over a list of exceptions; where the port classifies differently (torch's
out-of-memory error, its own kernel launch error), the test says so.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import fakepta_tpu.faults as jfaults
from fakepta_tpu import spectrum as jspec
from fakepta_tpu.batch import PulsarBatch as JaxBatch
from fakepta_tpu.parallel import montecarlo as jax_mc
from fakepta_tpu.parallel.mesh import make_mesh as jax_mesh
from fakepta_tpu.tune import defaults as jdefaults
from fakepta_tpu_torch import faults
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.parallel import montecarlo as mc
from fakepta_tpu_torch.parallel import pipeline
from fakepta_tpu_torch.tune import defaults
from fakepta_tpu_torch.utils.io import EnsembleCheckpoint

FAST = faults.RecoveryPolicy(backoff_s=0.001, max_backoff_s=0.01)
KW = dict(npsr=4, ntoa=32, tspan_years=5.0, seed=1)
TOL = {"f32": 1e-5, "bf16": 1e-2}


def _psd(tspan, ncomp=5):
    f = np.arange(1, ncomp + 1) / tspan
    return np.asarray(jspec.powerlaw(f, log10_A=-14.5, gamma=13 / 3))


@pytest.fixture(scope="module")
def tb():
    return PulsarBatch.synthetic(**KW, device="cpu")


def _sim(tb, path="einsum", **kw):
    return mc.EnsembleSimulator(
        tb, gwb=mc.GWBConfig(psd=_psd(float(tb.tspan_common)), orf="hd"),
        nbins=5, stat_path=path, pallas_precision="f32", device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine's XLA run of the chaos matrix's configuration, at
    f32 and with bf16 statistics (one build)."""
    jb = JaxBatch.synthetic(**KW)
    sim = jax_mc.EnsembleSimulator(
        jb, gwb=jax_mc.GWBConfig(psd=_psd(float(jb.tspan_common)),
                                 orf="hd"),
        nbins=5, mesh=jax_mesh(jax.devices()[:1]))
    return {p: sim.run(32, seed=3, chunk=8, precision=p)
            for p in ("f32", "bf16")}


@pytest.fixture(scope="module")
def sims(tb):
    return {p: _sim(tb, p) for p in mc.STAT_PATHS}


@pytest.fixture(scope="module")
def baseline(sims):
    out = sims["einsum"].run(32, seed=3, chunk=8)
    return {"curves": out["curves"], "autos": out["autos"]}


def _run(sim, **kw):
    kw.setdefault("recovery", FAST)
    return sim.run(32, seed=3, chunk=8, **kw)


def _within(got, want, prec):
    scale = float(np.abs(want["curves"]).max())
    np.testing.assert_allclose(got["curves"], want["curves"], rtol=0,
                               atol=TOL[prec] * scale)
    np.testing.assert_allclose(got["autos"], want["autos"], rtol=TOL[prec])


# ---------------------------------------------------------------------------
# the plan, the triage, the policy and the knob table
# ---------------------------------------------------------------------------

def test_fault_plan_is_deterministic_and_mirrors_jax():
    """Same specs, same site visits: the same fires in the same order, in
    both packages (per-site hit counters, ``times`` caps, ``match``
    counters of matching visits only)."""
    def drive(mod):
        plan = mod.FaultPlan([
            mod.FaultSpec("mc.dispatch", "poison", at=(1, 3)),
            mod.FaultSpec("mc.dispatch", "donation", at=(0, 1, 2),
                          times=2),
            mod.FaultSpec("fleet.heartbeat", "torn", at=(1,),
                          match=(("replica", "r1"),))])
        acts = []
        with mod.inject(plan):
            for i in range(5):
                acts.append(mod.check("mc.dispatch", idx=i))
            for rep in ("r0", "r1", "r0", "r1"):
                acts.append(mod.check("fleet.heartbeat", replica=rep))
            assert mod.active() is plan
        assert mod.active() is None
        return acts, plan.fired, dict(plan.hits)

    assert drive(faults) == drive(faults)
    assert drive(faults) == drive(jfaults)
    assert faults.check("mc.dispatch") is None        # no plan: free
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.FaultSpec("mc.dispatch", "melt")
    plan = faults.FaultPlan([faults.FaultSpec("mc.dispatch")])
    with faults.inject(plan):
        with pytest.raises(RuntimeError, match="already installed"):
            with faults.inject(plan):
                pass


_INJECTED = ("TransientFault", "FatalFault", "DegradeFault",
             "PrecisionFault")
# exceptions whose text the two packages classify alike
_ALIKE = [RuntimeError("RESOURCE_EXHAUSTED: out of HBM"),
          RuntimeError("UNAVAILABLE: socket closed"),
          RuntimeError("DEADLINE_EXCEEDED while waiting"),
          RuntimeError("the job was preempted"),
          RuntimeError("Mosaic failed to compile the kernel"),
          RuntimeError("pallas_call lowering failed"),
          ValueError("shapes (3,) and (4,) do not broadcast"),
          RuntimeError("kernel build failed:\n--- binned_corr ---"),
          RuntimeError("nvcc not found (looked on PATH)"),
          RuntimeError("CUDA error: an illegal memory access was "
                        "encountered"),
          RuntimeError("CUDA error: device-side assert triggered"),
          ConnectionResetError("connection reset by peer"),
          BrokenPipeError("broken pipe"),
          EOFError("eof while reading")]


@pytest.mark.parametrize("name", _INJECTED)
def test_classify_injected_types_label_for_label(name):
    port = getattr(faults, name)("x")
    ref = getattr(jfaults, name)("x")
    assert faults.classify(port) == jfaults.classify(ref)
    assert faults.classify_replica(port) == jfaults.classify_replica(ref)
    kill = faults.KillFault("x")
    assert faults.classify(kill) == "fatal"
    assert faults.classify_replica(kill) == "replica_death"


@pytest.mark.parametrize("exc", _ALIKE, ids=lambda e: str(e)[:32])
def test_classify_label_for_label_with_jax(exc):
    assert faults.classify(exc) == jfaults.classify(exc)
    assert faults.classify_replica(exc) == jfaults.classify_replica(exc)


@pytest.mark.parametrize("exc,label", [
    # torch's out-of-memory error: the port's transient class (the JAX
    # package's RESOURCE_EXHAUSTED); the JAX triage calls its text fatal
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 "
                            "GiB"), "transient"),
    # the port's own kernel launch error: the kernel class ('pallas'),
    # which steps the path ladder down
    (RuntimeError("binned_correlation failed to launch: CUDA error 1 "
                  "(invalid argument)"), "pallas"),
    # a sticky CUDA error in the same words: fatal, the context is lost
    (RuntimeError("chunk_stats failed to launch: CUDA error 700 (an "
                  "illegal memory access was encountered)"), "fatal"),
    (RuntimeError("binned_correlation failed to launch: CUDA error 710 "
                  "(device-side assert triggered)"), "fatal"),
], ids=["torch-oom", "launch-error", "sticky-illegal-address",
        "sticky-assert"])
def test_classify_the_ports_own_exceptions(exc, label):
    assert faults.classify(exc) == label
    assert faults.classify_replica(exc) == label
    assert faults.is_oom(exc) == (label == "transient")


def test_as_policy_matches_jax():
    def fields(p):
        return dataclasses.asdict(p)

    assert fields(faults.as_policy(None)) == fields(jfaults.as_policy(None))
    assert fields(faults.as_policy(False)) == fields(jfaults.DISABLED)
    assert faults.as_policy(False) is faults.DISABLED
    pol = faults.RecoveryPolicy(max_retries=5, watchdog_s=1.0)
    assert faults.as_policy(pol) is pol
    assert pol.next_backoff(0.05) == jfaults.RecoveryPolicy(
        max_retries=5, watchdog_s=1.0).next_backoff(0.05)
    with pytest.raises(TypeError, match="recovery must be None, False or "
                                        "a RecoveryPolicy, got int"):
        faults.as_policy(3)
    # the ladder: the JAX rungs that end on a hand-written kernel (the
    # port's einsum is the JAX xla path, the kernels' plain version)
    assert faults.PATH_LADDER == {
        k: v for k, v in jfaults.PATH_LADDER.items() if v != "xla"}


def test_tune_defaults_equal_jax_value_for_value():
    """Every constant of the port's knob table (the entries its engine,
    sampler, stream, telemetry plane, tuner, serve layer and gateway read)
    equals the JAX package's; the one mapped name: DEFAULT_PATH, the JAX
    "xla" path being the port's "einsum" path."""
    names = sorted(n for n in vars(defaults) if n.isupper())
    assert names == [
        "ALERT_APPEND_REGRESSION_X", "ALERT_HBM_WATERMARK_FRAC",
        "ALERT_HEARTBEAT_MISS_STREAK", "ALERT_P99_SLO_MS",
        "AUTOSCALE_COOLDOWN_S", "AUTOSCALE_HYSTERESIS",
        "AUTOSCALE_P99_HIGH_MS", "AUTOSCALE_P99_LOW_MS",
        "AUTOSCALE_TARGET_QPS_PER_REPLICA", "BREAKER_BACKOFF_BASE_S",
        "BREAKER_BACKOFF_CAP_S", "BREAKER_CLOSE_AFTER", "BUCKET_RATIO",
        "DEFAULT_BUCKETS", "DEFAULT_BYTES_BUDGET", "DEFAULT_CHUNK",
        "DEFAULT_FLEET_BUCKETS", "DEFAULT_PATH", "DEFAULT_PIPELINE_DEPTH",
        "DEPTH_CANDIDATES", "FS_LANE_BINS", "FS_TOUCH_TOL",
        "GATEWAY_CUTOVER_RTOL", "GATEWAY_DEFAULT_WEIGHT", "GATEWAY_DIR_ENV",
        "GATEWAY_INDEX_FILENAME", "GATEWAY_LATENCY_RING",
        "GATEWAY_MAX_INFLIGHT", "GATEWAY_RESULT_CACHE_CAP",
        "GATEWAY_RETRY_CAP_S", "GATEWAY_RETRY_MIN_S",
        "GATEWAY_SINGLEFLIGHT_CAP", "GATEWAY_STORE_CAP",
        "GATEWAY_STORE_SCHEMA", "GATEWAY_STORE_VERSION", "HBM_FRACTION",
        "HEARTBEAT_DEADLINE_S", "HEARTBEAT_PERIOD_S",
        "HEARTBEAT_SUSPECT_AFTER", "HEARTBEAT_WEDGED_AFTER",
        "PROBE_BUDGET_S", "PROBE_CHUNKS", "PROBE_TIMEOUT_S",
        "REFRESH_EVERY_APPENDS", "REFRESH_MIN_SNR_GAIN", "STORE_FILENAME",
        "STORE_SCHEMA", "STORE_VERSION", "STREAM_BLOCK_BUCKETS",
        "STREAM_GROWTH_RATIO", "TELEMETRY_RING_SIZE",
        "TELEMETRY_SCRAPE_EVERY", "TELEMETRY_WINDOW_S", "TUNE_DIR_ENV"]
    for n in names:
        want = getattr(jdefaults, n)
        if n == "DEFAULT_PATH":
            want = {"xla": "einsum"}[want]
        assert getattr(defaults, n) == want, n
    assert mc.DEFAULT_CHUNK == defaults.DEFAULT_CHUNK
    assert mc.DEFAULT_PIPELINE_DEPTH == defaults.DEFAULT_PIPELINE_DEPTH
    assert defaults.DEFAULT_PATH in mc.STAT_PATHS


# ---------------------------------------------------------------------------
# mc.dispatch: transient retry, exhaustion, poison, disabled
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["einsum", "fused", "mega"])
def test_dispatch_transient_retry_bit_identical(sims, jax_runs, path):
    unfaulted = _run(sims[path])
    plan = faults.FaultPlan(
        [faults.FaultSpec("mc.dispatch", "transient", at=(1,))])
    with faults.inject(plan):
        out = _run(sims[path])
    assert plan.fired == [("mc.dispatch", "transient", 1)]
    for k in ("curves", "autos"):
        np.testing.assert_array_equal(out[k], unfaulted[k])
    rep = out["report"]
    assert rep.counters.get("faults.injected") == 1
    assert rep.counters.get("faults.retries") == 1
    assert "degraded_path" not in rep.meta
    assert any(ev["name"] == "retry" for ev in rep.timeline)
    assert out["statistic_path"] == path
    _within(out, jax_runs["f32"], "f32")


def test_dispatch_oom_is_retried(sims, baseline, monkeypatch):
    """torch's out-of-memory error at a chunk's dispatch is the transient
    class: the same chunk is dispatched again, bit-identical."""
    sim = sims["einsum"]
    real, calls = sim.step, []

    def step(*a, **kw):
        calls.append(a[1])
        if len(calls) == 2:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                         "allocate 1.00 GiB")
        return real(*a, **kw)

    monkeypatch.setattr(sim, "step", step)
    out = _run(sim)
    assert calls == [0, 8, 8, 16, 24]
    assert out["report"].counters.get("faults.retries") == 1
    np.testing.assert_array_equal(out["curves"], baseline["curves"])


@pytest.mark.parametrize("message,degrades", [
    ("chunk_stats failed to launch: CUDA error 1 (invalid argument)", True),
    ("chunk_stats failed to launch: CUDA error 700 (an illegal memory "
     "access was encountered)", False),
    ("CUDA error: device-side assert triggered", False),
    ("kernel build failed:\n--- megakernel (nvcc exit 1) ---", False)],
    ids=["launch-error", "sticky-illegal-address", "sticky-assert",
         "build-failure"])
def test_kernel_failures_from_a_stub(sims, baseline, monkeypatch, message,
                                     degrades):
    """A kernel's launch error at a dispatch steps the ladder down; a
    sticky CUDA error (the context is lost) and a kernel build failure
    propagate at once, with no retry and no degradation."""
    sim = sims["mega"]
    real, calls = sim.step, []

    def step(*a, **kw):
        calls.append(a[3])
        if a[3] == "mega":
            raise RuntimeError(message)
        return real(*a, **kw)

    monkeypatch.setattr(sim, "step", step)
    if degrades:
        out = _run(sim)
        assert out["statistic_path"] == "fused"
        assert out["report"].counters.get("faults.degradations") == 1
        assert calls == ["mega"] + ["fused"] * 4
        _within(out, baseline, "f32")
    else:
        with pytest.raises(RuntimeError, match="CUDA error|build failed"):
            _run(sim)
        assert calls == ["mega"]


def test_dispatch_transient_exhausted_fails_loud_with_dump(
        sims, tmp_path, monkeypatch):
    monkeypatch.setenv("FAKEPTA_TORCH_FLIGHTREC_DIR", str(tmp_path))
    plan = faults.FaultPlan(
        [faults.FaultSpec("mc.dispatch", "transient", at=(0, 1, 2, 3),
                          times=4)])
    with faults.inject(plan):
        with pytest.raises(faults.TransientFault):
            _run(sims["einsum"], recovery=faults.RecoveryPolicy(
                max_retries=2, backoff_s=0.001))
    dumps = list(tmp_path.glob("flightrec-*.json"))
    assert dumps, "a fail-loud abort must leave a flight-recorder dump"
    text = dumps[0].read_text()
    assert "fault_fired" in text and "chunk_retry" in text


@pytest.mark.parametrize("depth", [2, 0], ids=["pipelined", "serial"])
def test_dispatch_poison_fails_loud(sims, tmp_path, monkeypatch, depth):
    # serial without checkpoint/progress materializes nothing until the
    # final fetch: the end-of-run guard still catches the poison
    monkeypatch.setenv("FAKEPTA_TORCH_FLIGHTREC_DIR", str(tmp_path))
    plan = faults.FaultPlan(
        [faults.FaultSpec("mc.dispatch", "poison", at=(1,))])
    with faults.inject(plan):
        with pytest.raises(FloatingPointError, match="non-finite"):
            _run(sims["fused"], pipeline_depth=depth)
    assert list(tmp_path.glob("flightrec-*.json"))


def test_recovery_disabled_propagates_immediately(sims):
    plan = faults.FaultPlan(
        [faults.FaultSpec("mc.dispatch", "transient", at=(0,))])
    with faults.inject(plan):
        with pytest.raises(faults.TransientFault):
            _run(sims["einsum"], recovery=False)
    assert plan.fired == [("mc.dispatch", "transient", 0)]
    plan = faults.FaultPlan(
        [faults.FaultSpec("mc.dispatch", "degrade", at=(0,))])
    with faults.inject(plan):
        with pytest.raises(faults.DegradeFault):
            _run(sims["mega"], recovery=False)


def test_default_recovery_retries(sims, baseline):
    """``recovery=None`` (the default) is the default policy, as in JAX:
    a transient chunk failure is retried, not fatal."""
    plan = faults.FaultPlan(
        [faults.FaultSpec("mc.dispatch", "transient", at=(2,))])
    with faults.inject(plan):
        out = sims["einsum"].run(32, seed=3, chunk=8)
    assert out["report"].counters.get("faults.retries") == 1
    np.testing.assert_array_equal(out["curves"], baseline["curves"])


# ---------------------------------------------------------------------------
# pipeline.writer: drain retry + the watchdog on a hung drain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [2, 0], ids=["pipelined", "serial"])
def test_writer_transient_retry_recovers(sims, baseline, tmp_path, depth):
    plan = faults.FaultPlan(
        [faults.FaultSpec("pipeline.writer", "transient", at=(1,))])
    with faults.inject(plan):
        out = _run(sims["einsum"], pipeline_depth=depth,
                   checkpoint=tmp_path / "w.npz")
    assert plan.fired == [("pipeline.writer", "transient", 1)]
    np.testing.assert_array_equal(out["curves"], baseline["curves"])
    assert out["report"].counters.get("faults.retries") == 1


def test_writer_hang_watchdog_aborts_with_dump(sims, tmp_path, monkeypatch):
    monkeypatch.setenv("FAKEPTA_TORCH_FLIGHTREC_DIR", str(tmp_path))
    plan = faults.FaultPlan(
        [faults.FaultSpec("pipeline.writer", "hang", at=(0,), hang_s=2.0)])
    with faults.inject(plan):
        with pytest.raises(faults.WatchdogTimeout):
            _run(sims["einsum"],
                 recovery=faults.RecoveryPolicy(watchdog_s=0.25))
    dumps = list(tmp_path.glob("flightrec-*.json"))
    assert dumps and "watchdog" in dumps[0].read_text()


def test_drain_retry_and_writers_unit(monkeypatch):
    """``run_drain_with_retry``: a transient failure is retried in place
    under the policy's whole backoff schedule (``backoff_s`` growing by
    ``backoff_mult`` up to ``max_backoff_s``), anything else propagates at
    once, and ``ThreadWriter.close(timeout=...)`` raises the watchdog's
    error on a drain still running."""
    seen, retries, slept = [], [], []
    monkeypatch.setattr(faults.recovery, "sleep", slept.append)

    def flaky(fails, exc):
        def drain():
            seen.append(1)
            if len(seen) <= fails:
                raise exc
        return drain

    pol = faults.RecoveryPolicy(max_retries=4, backoff_s=0.001,
                                backoff_mult=3.0, max_backoff_s=0.005)
    pipeline.run_drain_with_retry(flaky(4, faults.TransientFault("t")), pol,
                                  on_retry=retries.append)
    assert len(seen) == 5 and retries == [1, 2, 3, 4]
    assert slept == [0.001, 0.003, 0.005, 0.005]
    seen.clear()
    with pytest.raises(faults.FatalFault):
        pipeline.run_drain_with_retry(flaky(1, faults.FatalFault("f")),
                                      pol)
    assert seen == [1]
    seen.clear()
    with pytest.raises(faults.TransientFault):
        pipeline.run_drain_with_retry(flaky(9, faults.TransientFault("t")),
                                      faults.RecoveryPolicy(max_retries=1))
    assert len(seen) == 2
    seen.clear()
    with pytest.raises(faults.TransientFault):
        pipeline.run_drain_with_retry(flaky(1, faults.TransientFault("t")),
                                      faults.DISABLED)
    assert seen == [1]
    import threading
    gate = threading.Event()
    writer = pipeline.make_writer(True)
    writer.submit(lambda: gate.wait(5.0))
    with pytest.raises(faults.WatchdogTimeout):
        writer.close(timeout=0.05)
    gate.set()
    writer.abort()


# ---------------------------------------------------------------------------
# degradation ladders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_path_ladder_mega_fused(sims, jax_runs, prec):
    """A kernel failure steps mega -> fused at the SAME precision; the
    fused rung's chunks stay within the engine's bound of the JAX XLA run,
    and the degradation is counted, recorded and reported. A kernel failure
    on the fused rung propagates: the port never falls back from a kernel
    to the plain einsum path (the JAX ladder's last rung, xla)."""
    assert faults.PATH_LADDER == {"mega": "fused"}
    plan = faults.FaultPlan(
        [faults.FaultSpec("mc.dispatch", "degrade", at=(1,))])
    with faults.inject(plan):
        out = _run(sims["mega"], precision=prec)
    rep = out["report"]
    assert out["statistic_path"] == "fused" and out["precision"] == prec
    assert rep.meta["degraded_path"] == "fused"
    assert rep.meta["degraded_precision"] == prec
    assert rep.counters.get("faults.degradations") == 1
    steps = [(ev["from"], ev["to"]) for ev in rep.timeline
             if ev["name"] == "degrade"]
    assert steps == [(f"mega/{prec}", f"fused/{prec}")]
    _within(out, jax_runs[prec], prec)
    # a second kernel failure, now on the fused rung, ends the run; so
    # does one on a fused run from its first chunk
    for path, at in (("mega", (1, 3)), ("fused", (0,))):
        plan = faults.FaultPlan(
            [faults.FaultSpec("mc.dispatch", "degrade", at=at)])
        with faults.inject(plan):
            with pytest.raises(faults.DegradeFault):
                _run(sims[path], precision=prec)


def test_fused_launch_failure_is_fatal(sims, jax_runs, monkeypatch):
    """The port's own launch error (ops/_build.py's "failed to launch:
    CUDA error") is the kernel class: on the mega path the chunk
    re-dispatches on fused, on the fused path it propagates unchanged."""
    err = ("binned_correlation failed to launch: CUDA error 9 (invalid "
           "configuration argument)")
    assert faults.classify(RuntimeError(err)) == "pallas"

    def failing(sim, bad_path):
        real = sim.step

        def step(*a, **kw):
            if a[3] == bad_path:
                raise RuntimeError(err)
            return real(*a, **kw)
        return step

    monkeypatch.setattr(sims["mega"], "step", failing(sims["mega"], "mega"))
    out = _run(sims["mega"])
    assert out["statistic_path"] == "fused"
    assert out["report"].counters.get("faults.degradations") == 1
    _within(out, jax_runs["f32"], "f32")
    monkeypatch.setattr(sims["fused"], "step",
                        failing(sims["fused"], "fused"))
    with pytest.raises(RuntimeError, match="failed to launch"):
        _run(sims["fused"])


def test_path_ladder_keeps_the_vpu_kernel(tb, jax_runs):
    """The fused rung keeps the simulator's ``pallas_mxu_binning``: a
    degraded mega run with it off finishes on #2's plain path."""
    sim = _sim(tb, "mega", pallas_mxu_binning=False)
    plan = faults.FaultPlan(
        [faults.FaultSpec("mc.dispatch", "degrade", at=(0,))])
    with faults.inject(plan):
        out = _run(sim)
    assert out["statistic_path"] == "fused"
    assert sim._fused_kernel().__name__ == "binned_correlation_vpu"
    _within(out, jax_runs["f32"], "f32")


def test_precision_degradation_bf16_to_f32(sims, jax_runs):
    plan = faults.FaultPlan(
        [faults.FaultSpec("mc.dispatch", "precision", at=(0,))])
    with faults.inject(plan):
        out = _run(sims["fused"], precision="bf16")
    rep = out["report"]
    assert rep.meta.get("degraded_precision") == "f32"
    assert rep.counters.get("faults.degradations") == 1
    assert out["precision"] == "f32"
    # every chunk re-dispatched at f32: the f32 run of the same path
    np.testing.assert_array_equal(out["curves"],
                                  _run(sims["fused"])["curves"])
    _within(out, jax_runs["f32"], "f32")


def test_recycle_miss_degrades_not_aborts(sims, baseline):
    plan = faults.FaultPlan(
        [faults.FaultSpec("mc.recycle", "donation", at=(0,))])
    with faults.inject(plan):
        out = _run(sims["einsum"])
    rep = out["report"]
    assert rep.meta.get("degraded_donation") is True
    assert rep.counters.get("faults.degradations") == 1
    assert rep.memory.get("packed_ring_degraded") == 1
    assert "packed_depth_bound_bytes" not in rep.memory
    assert not any(ev["name"] == "recycle" and ev["chunk"] > 2
                   for ev in rep.timeline)
    np.testing.assert_array_equal(out["curves"], baseline["curves"])
    # without the ladder the miss fails the ring's end-of-run check
    plan = faults.FaultPlan(
        [faults.FaultSpec("mc.recycle", "donation", at=(0,))])
    with faults.inject(plan):
        with pytest.raises(RuntimeError, match="reuse"):
            _run(sims["einsum"], recovery=dataclasses.replace(
                FAST, degrade_pipeline=False))


# ---------------------------------------------------------------------------
# ckpt.append: torn writes, rollback, kill-resume
# ---------------------------------------------------------------------------

def test_ckpt_torn_write_kill_resume_bit_identical(sims, baseline,
                                                   tmp_path):
    ck = str(tmp_path / "ck.npz")
    plan = faults.FaultPlan(
        [faults.FaultSpec("ckpt.append", "torn", at=(2,))])
    with faults.inject(plan):
        with pytest.raises(faults.KillFault):
            _run(sims["einsum"], checkpoint=ck)
    # the torn chunk file is on disk and named by the manifest: resume
    # must see the bad CRC, roll back and reproduce the stream bit for bit
    out = _run(sims["einsum"], checkpoint=ck)
    np.testing.assert_array_equal(out["curves"], baseline["curves"])
    np.testing.assert_array_equal(out["autos"], baseline["autos"])
    assert out["report"].counters.get("faults.rollbacks") == 1
    assert not list(tmp_path.glob("ck.npz*")), "completed run cleans up"


def test_ckpt_rollback_unit(tmp_path):
    ck = EnsembleCheckpoint(tmp_path / "u.npz")

    def cur(k):
        return np.full((4, 3), float(k))

    def au(k):
        return np.full((4,), float(k))

    for k in range(3):
        ck.save(0, 12, 4, 4 * (k + 1), cur(k), au(k))
    # tear the middle chunk: the rollback drops chunks 1 AND 2
    p = ck._chunk_path(1)
    p.write_bytes(p.read_bytes()[: p.stat().st_size // 2])
    st = EnsembleCheckpoint(tmp_path / "u.npz").load(0, 12, 4)
    assert st["done"] == 4 and st["rolled_back"] == 2
    np.testing.assert_array_equal(st["curves"], cur(0))
    # an unreadable manifest is a loud restart, never a crash
    (tmp_path / "u.npz").write_bytes(b"garbage")
    assert EnsembleCheckpoint(tmp_path / "u.npz").load(0, 12, 4) is None
