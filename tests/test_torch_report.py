"""The port's run report and observability core, on the CPU, against the
JAX package's: the same summary keys for the same run, files each package
reads from the other, and the same metric-direction tables and text.
"""

import jax
import numpy as np
import pytest
import torch

from fakepta_tpu import spectrum as jspec
from fakepta_tpu.batch import PulsarBatch as JaxBatch
from fakepta_tpu.obs import metrics as jax_metrics
from fakepta_tpu.obs import report as jax_report
from fakepta_tpu.parallel.mesh import make_mesh as jax_mesh
from fakepta_tpu.parallel.montecarlo import EnsembleSimulator as JaxSim
from fakepta_tpu.parallel.montecarlo import GWBConfig as JaxGWB
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.obs import flightrec, memwatch, metrics, report, timing
from fakepta_tpu_torch.parallel.montecarlo import (EnsembleSimulator,
                                                   GWBConfig)

KW = dict(npsr=8, ntoa=64, tspan_years=10.0, toaerr=1e-7, n_red=4, n_dm=4,
          seed=1)

# summary keys only the JAX package's report has for this run, and why:
JAX_ONLY_KEYS = {
    # XLA's cost analysis of the compiled chunk program; the port runs
    # eager kernels and reports the analytic model_bytes_per_chunk only
    "cost_bytes_per_chunk", "cost_flops_per_chunk",
    "intensity_flop_per_byte",
    # on the CPU the JAX package models it from XLA's memory analysis of
    # the compiled program; the port reports the CUDA allocator's peak,
    # on the card only (tests/test_torch_cuda.py checks it there)
    "peak_hbm_bytes"}


def _psd(tspan, ncomp=4):
    f = np.arange(1, ncomp + 1) / tspan
    return np.asarray(jspec.powerlaw(f, log10_A=-13.5, gamma=13 / 3))


@pytest.fixture(scope="module")
def port_out():
    tb = PulsarBatch.synthetic(**KW, device="cpu")
    sim = EnsembleSimulator(tb, gwb=GWBConfig(psd=_psd(
        float(tb.tspan_common))), stat_path="einsum", device="cpu")
    return sim, sim.run(32, seed=3, chunk=8)


@pytest.fixture(scope="module")
def jax_rep():
    jb = JaxBatch.synthetic(**KW)
    sim = JaxSim(jb, gwb=JaxGWB(psd=_psd(float(jb.tspan_common))),
                 mesh=jax_mesh(jax.devices()[:1]))
    return sim.run(32, seed=3, chunk=8)["report"]


def test_summary_keys_are_the_jax_keys(port_out, jax_rep):
    sim, out = port_out
    rep = out["report"]
    assert rep is sim.last_report
    mine, theirs = set(rep.summary()), set(jax_rep.summary())
    assert mine >= theirs - JAX_ONLY_KEYS, theirs - JAX_ONLY_KEYS - mine
    assert JAX_ONLY_KEYS <= theirs      # the list names real differences
    for k in ("nreal", "chunk", "keep_corr", "fused", "precision",
              "platform", "n_devices", "mesh_shape", "npsr", "max_toa",
              "pipeline_depth", "process_index", "process_count", "seed"):
        assert rep.meta[k] == jax_rep.meta[k], k
    assert rep.meta["statistic_path"] == "einsum"    # the JAX 'xla'
    assert rep.meta["device_kind"] == "cpu"
    assert rep.summary()["model_bytes_per_chunk"] == \
        jax_rep.summary()["model_bytes_per_chunk"]
    assert rep.retraces == 0 and rep.compile_s == 0.0
    assert rep.counters["obs.chunks"] == 4
    assert {"keys", "residuals", "statistic"} <= set(rep.spans)


def test_chunk_records(port_out, jax_rep):
    rep = port_out[1]["report"]
    assert len(rep.chunks) == 4
    for c, j in zip(rep.chunks, jax_rep.chunks):
        assert set(c) >= set(j), set(j) - set(c)
        assert c["synced"] is False and c["execute_s"] >= 0.0
    tids = {(e["name"], e["tid"]) for e in rep.timeline}
    assert {("dispatch", "main"), ("drain", "writer"),
            ("execute", "device"), ("final_fetch", "main")} <= tids


def test_saved_reports_load_in_either_package(port_out, jax_rep, tmp_path):
    rep = port_out[1]["report"]
    rep.save(tmp_path / "port.jsonl")
    theirs = jax_report.RunReport.load(tmp_path / "port.jsonl")
    assert theirs.summary() == rep.summary()
    assert theirs.chunks == rep.chunks and theirs.meta == rep.meta
    back = report.RunReport.load(tmp_path / "port.jsonl")
    assert back.summary() == rep.summary()
    assert back.timeline == sorted(rep.timeline, key=lambda e: e["t0"])
    jax_rep.save(tmp_path / "jax.jsonl")
    mine = report.RunReport.load(tmp_path / "jax.jsonl")
    assert mine.summary() == jax_rep.summary()
    # the two packages print and compare a report alike
    assert report.format_summary(mine) == jax_report.format_summary(jax_rep)
    assert report.format_delta(back, mine) == \
        jax_report.format_delta(theirs, jax_rep)


def test_metric_tables_are_the_jax_tables():
    for name in ("HIGHER_IS_BETTER", "HIGHER_SUFFIXES", "EXEMPT_METRICS",
                 "EXEMPT_SUFFIXES", "ROW_IDENTITY", "LOWER_IS_BETTER"):
        assert getattr(report, name) == getattr(jax_report, name), name
    for k in ("real_per_s", "pipeline_stall_s", "ckpt_wait_s", "chunks",
              "os_hd_detection_rate", "x_amp2_mean", "peak_hbm_bytes"):
        assert report.metric_higher_is_better(k) == \
            jax_report.metric_higher_is_better(k)
        assert report.metric_exempt(k) == jax_report.metric_exempt(k)


def test_event_log_schema_and_collector(tmp_path):
    assert metrics.SCHEMA == jax_metrics.SCHEMA
    assert metrics.ACCEPTED_SCHEMAS == jax_metrics.ACCEPTED_SCHEMAS
    c = metrics.Collector()
    metrics.count("x")                   # no active collector: a no-op
    with metrics.collect(c):
        metrics.count("x", 2)
        metrics.gauge("g", 1.5)
        metrics.observe("t", 0.25)
        metrics.record_span("s")
        metrics.event("e", 3, why="test")
    assert metrics.active() is None
    assert c.counters == {"x": 2} and c.gauges == {"g": 1.5}
    assert c.timing_summary() == {"t": {"n": 1, "total_s": 0.25,
                                        "mean_s": 0.25}}
    log = metrics.EventLog(meta={"a": 1})
    log.extend_from(c)
    log.save(tmp_path / "e.jsonl", summary={"m": 1})
    theirs = jax_metrics.EventLog.load(tmp_path / "e.jsonl")
    assert theirs.lines[:-1] == log.lines and theirs.summary() == {"m": 1}
    assert flightrec.snapshot()[-1]["name"] == "e"
    with pytest.raises(ValueError, match="schema"):
        metrics.EventLog(schema="other/9")
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"kind": "header", "schema": "other/9"}\n')
    with pytest.raises(ValueError, match="refusing"):
        metrics.EventLog.load(bad)


def test_a_failing_run_dumps_the_flight_recorder(port_out, tmp_path,
                                                 monkeypatch):
    sim = port_out[0]
    monkeypatch.setenv(flightrec.DUMP_DIR_ENV, str(tmp_path))

    def boom(done, nreal):
        if done >= 16:
            raise RuntimeError("stop here")

    with pytest.raises(RuntimeError, match="stop here"):
        sim.run(32, seed=3, chunk=8, progress=boom)
    dumps = sorted(tmp_path.glob("flightrec-*.json"))
    assert len(dumps) == 1
    rep = jax_report.RunReport.load(dumps[0])
    assert rep.meta["flightrec"] and "stop here" in rep.meta["error"]
    assert rep.meta["spec_hash"] == flightrec.spec_hash(
        {k: v for k, v in rep.meta.items()
         if k not in ("flightrec", "spec_hash", "crash_time", "error")})
    assert 2 <= len(rep.chunks) <= 4


def test_memwatch_on_the_host():
    sampler = memwatch.HbmSampler(["cpu"])
    assert sampler.start() is False and sampler.stop() == {}
    ledger = memwatch.PackedLedger(64, ring_size=2, pipelined=True)
    a, b = torch.zeros(16), torch.zeros(16)
    assert ledger.track(a) == 1 and ledger.track(b) == 2
    del a                                # drained: no longer counted
    c = torch.zeros(16)
    assert ledger.track(c) == 2
    ledger.check()
    assert ledger.memory_fields() == {"packed_buffer_bytes": 64,
                                      "packed_buffers_live_peak": 2,
                                      "packed_depth_bound_bytes": 128}
    d = torch.zeros(16)                  # b is still held: 3 live
    assert ledger.track(d) == 3
    with pytest.raises(RuntimeError, match="3 packed buffers live"):
        ledger.check()
    serial = memwatch.PackedLedger(64, ring_size=1, pipelined=False)
    kept = [torch.zeros(16) for _ in range(3)]
    for t in kept:
        serial.track(t)
    serial.check()                       # the serial loop claims no bound
    assert serial.memory_fields()["packed_buffers_live_peak"] == 3


def test_timer_records_even_when_the_block_raises():
    t = timing.Timer()
    with pytest.raises(KeyError):
        with t.section("a") as keep:
            keep(np.zeros(2))
            raise KeyError
    with t.section("a"):
        pass
    assert t.summary()["a"]["n"] == 2


def test_compile_s_is_the_kernel_build_time():
    c = metrics.Collector()
    c.observe("kernels.build_s", 1.5)
    c.observe("kernels.build_s", 0.5)
    rep = report.RunReport.from_collector(c, {"nreal": 4, "chunk": 2},
                                          total_s=4.0)
    rep.chunks = [{"wall_s": 2.5}, {"wall_s": 1.5}]
    assert rep.compile_s == 2.0
    # the build-bearing first chunk leaves the steady rate
    assert rep.steady_real_per_s() == pytest.approx(2 / 1.5)
