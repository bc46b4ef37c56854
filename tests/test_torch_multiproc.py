"""Multi-process meshes of the port, on the CPU: two gloo ranks.

One module fixture starts two worker processes
(tests/_torch_multiproc_worker.py) that join a process group through a
FileStore in ``tmp_path`` (no TCP port: parallel test workers cannot
collide), with four CPU entries each, one torch thread each. They run
every case on their multi-process mesh and print one JSON line; rank 0
also runs the one-process mesh of the same global shape in the same
process. Each case must equal that run bit for bit on both ranks, and the
JAX engine on the conftest's virtual CPU devices within rtol 1e-5 / atol
1e-6 of the curve scale (tests/test_multihost.py's bounds; bf16 operand
modes at the port's 1e-2 bf16 bound, the OS lanes at the detection lane's
1e-4 of max|amp2|, the likelihood lanes at tests/lane_bound.py's float32
bound, against the JAX lane on one device: its gradient over a psr mesh is
wrong, ROADMAP Queue 3; the float64 batch's fused and mega cases against
the JAX XLA run of the same float64 leaves at those bounds, their curves
float32 and float64 as the JAX engine's are). Only rank 0 writes checkpoint files, a cut run resumes from a
shared directory to the uninterrupted one, the event-log shards merge
into one trace with pid lanes {0, 1}, the 2-rank sampler's chains (over
'real', 'psr' and a replicated 'toa' axis) equal the one-process run bit
for bit and the JAX sampler's at 1e-9 (float64), and a fault on one rank
raises on both instead of hanging.

The stream (tests/test_stream.py's template and blocks) on the ``psr``
and ``cross`` layouts equals the one-process mesh's bit for bit on both
ranks (moments, lnL, restage, the rolling OS and a detection sequence),
and the JAX stream's within test_torch_stream.py's bounds (1e-10 relative
for the moments and lnL, 1e-9 for the OS, the same detection count); its
checkpoint files are rank 0's alone, a stream cut after two appends
resumes from a shared directory bit-identically, and both refreshers run
on it as on the one-process mesh. ``tune.search`` over both ranks'
entries returns one TunedConfig on both, leaves one store file, probes
``candidate_frontier``'s list for the global fingerprint and is warm the
second time. A fault on rank 1 in an append or before a probe raises on
both ranks within a second, and both go on.

The test skips only when the group fails to come up before the workers'
sentinel line, as tests/test_multihost.py does; any failure after it fails.

tests/test_multihost.py's worker builds its (2, 2, 2) mesh from the
rank-major ``jax.devices()``, which puts each process's four devices in one
real row, so neither its psr gather nor its toa psum crosses processes
(:func:`test_reference_rank_major_mesh_crosses_no_process_in_a_row`).
The port's ``cross`` layout puts entry (r, s, t) on rank (s + t) % 2, so
that both do.
"""

import json
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _multihost_worker as cfg
import _torch_multiproc_worker as wcfg
from fakepta_tpu import infer as jinfer
from fakepta_tpu import obs as jobs
from fakepta_tpu import spectrum as jax_spectrum
from fakepta_tpu.batch import PulsarBatch as JaxBatch
from fakepta_tpu.detect import OSSpec as JaxOSSpec
from fakepta_tpu.detect.streaming import StreamingOS as JaxOS
from fakepta_tpu.parallel.mesh import make_mesh as jax_mesh
from fakepta_tpu.parallel.montecarlo import EnsembleSimulator as JaxSim
from fakepta_tpu.parallel.montecarlo import GWBConfig as JaxGWB
from fakepta_tpu.sample import SampleSpec as JSpec
from fakepta_tpu.sample import SamplingRun as JRun
from fakepta_tpu.stream import StreamState as JaxStream
from fakepta_tpu.stream import default_stream_model as jax_stream_model
from fakepta_tpu_torch import infer, tune
from fakepta_tpu_torch import spectrum as spectrum_lib
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.obs.report import RunReport
from fakepta_tpu_torch.obs.trace import build_trace, validate_trace
from fakepta_tpu_torch.parallel.montecarlo import (EnsembleSimulator,
                                                   GWBConfig)
from lane_bound import assert_lanes, lane_unit

WORKER = pathlib.Path(__file__).parent / "_torch_multiproc_worker.py"
SENTINEL = "MULTIPROC_INIT_OK"
DEADLINE_S = 240
BF16_TOL = 1e-2
OS_TOL = 1e-4
CASES = tuple(wcfg.CASES)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' JSON results, by rank."""
    out_dir = tmp_path_factory.mktemp("multiproc")
    # output to files, not pipes: a rank blocked on a full pipe nobody
    # reads would hold the other inside a collective
    logs = [(out_dir / f"out{r}", out_dir / f"err{r}")
            for r in range(wcfg.NRANKS)]
    procs = []
    for r, (out_p, err_p) in enumerate(logs):
        with open(out_p, "w") as out_f, open(err_p, "w") as err_f:
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), str(out_dir), str(r),
                 str(wcfg.NRANKS)], stdout=out_f, stderr=err_f))
    t_end = time.monotonic() + DEADLINE_S
    results = {}
    try:
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(t_end - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                if SENTINEL in logs[r][1].read_text():
                    raise AssertionError(
                        f"rank {r} hung after the group came up:\n"
                        + "\n".join(err.strip().splitlines()[-8:]))
                pytest.skip("the process group did not come up in time")
            out, err = logs[r][0].read_text(), logs[r][1].read_text()
            tail = "\n".join(err.strip().splitlines()[-8:])
            if p.returncode != 0:
                if SENTINEL in err:
                    raise AssertionError(
                        f"rank {r} failed after the group came up:\n{tail}")
                markers = ("address already in use", "connection refused",
                           "gloo", "timed out", "unavailable")
                if any(m in tail.lower() for m in markers):
                    pytest.skip(f"the process group did not come up:\n"
                                f"{tail}")
                raise AssertionError(f"rank {r} failed:\n{tail}")
            results[r] = json.loads(out.strip().splitlines()[-1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results["dir"] = out_dir
    return results


def _plain(case: dict) -> dict:
    return {k: v for k, v in case.items() if k != "meta"}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine's runs the cases are held to, on the conftest's
    virtual CPU devices."""
    def sim(psr, toa, n=None):
        devs = jax.devices()[:n] if n else jax.devices()
        return cfg.build_sim(jax_mesh(devs, psr_shards=psr, toa_shards=toa))

    run = dict(cfg.RUN)
    nreal = run.pop("nreal")
    psr2 = sim(2, 1, 2)
    jb = JaxBatch.synthetic(**cfg.SIM)
    # the float64 cases' batch: the port's float32 leaves at float64
    leaves = wcfg.f64_batch(PulsarBatch.synthetic(**cfg.SIM,
                                                  device="cpu")).numpy()
    jb64 = JaxBatch(**{k: jnp.asarray(v) for k, v in leaves.items()})
    f = np.arange(1, cfg.GWB["ncomp"] + 1) / float(jb64.tspan_common)
    psd = np.asarray(jax_spectrum.powerlaw(f, log10_A=cfg.GWB["log10_A"],
                                           gamma=cfg.GWB["gamma"]))
    psr2_f64 = JaxSim(jb64, gwb=JaxGWB(psd=psd, orf="hd"),
                      mesh=jax_mesh(jax.devices()[:2], psr_shards=2))
    theta = jinfer.theta_grid(wcfg.lnl_model(jinfer), wcfg.THETA_SHAPE)
    return {
        "cross": sim(2, 2).run(nreal, keep_corr=True, **run),
        "psr2": psr2.run(nreal, **run),
        "psr2_f64": psr2_f64.run(nreal, **run),
        "os": psr2.run(nreal, os=JaxOSSpec(orf=wcfg.OS_ORFS, null=True),
                       **run),
        # on one device: the JAX lane's gradient over a psr mesh is its
        # psr shard count times too large (ROADMAP Queue 3, faults in the
        # reference), and the streams do not depend on the mesh
        "lnl": sim(1, 1, 1).run(nreal, lnlike=jinfer.InferSpec(
            model=wcfg.lnl_model(jinfer), theta=theta, mode="grad"),
            **run),
        "batch": jb,
    }


@pytest.mark.parametrize("case", CASES)
def test_case_bit_identical_to_the_one_process_mesh(ranks, case):
    ref = _plain(ranks[0]["ref"][case])
    for r in range(wcfg.NRANKS):
        got = ranks[r]["cases"][case]
        assert json.dumps(_plain(got), sort_keys=True) == json.dumps(
            ref, sort_keys=True), (case, r)
        assert got["meta"]["process_index"] == r
        assert got["meta"]["process_count"] == wcfg.NRANKS
        assert got["meta"]["backend"] == "gloo"
    assert ranks[0]["ref"][case]["meta"]["mesh_shape"] == \
        ranks[0]["cases"][case]["meta"]["mesh_shape"]


@pytest.mark.parametrize("case", CASES)
def test_case_matches_the_jax_engine(ranks, jax_runs, case):
    got = ranks[1]["cases"][case]
    layout, _, kw, rkw = wcfg.CASES[case]
    if kw.get("dtype") == "float64":
        assert got["dtype"] == ("float32" if kw["stat_path"] == "fused"
                                else "float64")
    want = jax_runs["cross" if layout in ("cross", "rank_major")
                    else "os" if "os" in rkw
                    else "psr2_f64" if kw.get("dtype") == "float64"
                    else "psr2"]
    if "lnlike" in rkw:
        want = jax_runs["lnl"]
    tol = BF16_TOL if rkw.get("precision") == "bf16" else 1e-6
    scale = np.abs(want["curves"]).max()
    np.testing.assert_allclose(got["curves"], want["curves"],
                               rtol=1e-5 if tol < BF16_TOL else 0,
                               atol=tol * scale)
    np.testing.assert_allclose(got["autos"], want["autos"],
                               rtol=1e-5 if tol < BF16_TOL else BF16_TOL)
    if "corr" in got:
        cscale = np.abs(want["corr"]).max()
        np.testing.assert_allclose(got["corr"], want["corr"], rtol=1e-5,
                                   atol=1e-6 * cscale)
    if "os" in got:
        for orf in wcfg.OS_ORFS:
            stats = want["os"]["stats"][orf]
            amp = np.abs(stats["amp2"]).max()
            for k in ("amp2", "null_amp2"):
                np.testing.assert_allclose(got["os"][orf][k], stats[k],
                                           rtol=0, atol=OS_TOL * amp,
                                           err_msg=f"{orf}/{k}")
    if "lnlike" in got:
        tb = PulsarBatch.synthetic(**cfg.SIM, device="cpu")
        f = np.arange(1, cfg.GWB["ncomp"] + 1) / float(tb.tspan_common)
        psd = spectrum_lib.powerlaw(f, log10_A=cfg.GWB["log10_A"],
                                    gamma=cfg.GWB["gamma"]).numpy()
        sim = EnsembleSimulator(tb, gwb=GWBConfig(psd=psd, orf="hd"),
                                stat_path="einsum", device="cpu")
        theta = infer.theta_grid(wcfg.lnl_model(infer), wcfg.THETA_SHAPE)
        spec = infer.InferSpec(model=wcfg.lnl_model(infer), theta=theta,
                               mode="grad")
        lanes = {k: np.asarray(v) for k, v in got["lnlike"].items()}
        lanes["theta"] = np.asarray(want["lnlike"]["theta"])
        assert_lanes(lanes, want["lnlike"],
                     lane_unit(sim, spec, cfg.RUN["seed"], cfg.RUN["chunk"]),
                     ("lnl", "grad"), case)


def test_every_rank_builds_the_one_process_batch(ranks):
    """The batch each rank builds from the seed is the one-process batch,
    field for field, bit for bit."""
    want = wcfg.batch_digest(PulsarBatch.synthetic(**cfg.SIM, device="cpu"))
    assert [ranks[r]["batch_digest"] for r in range(wcfg.NRANKS)] == \
        [want] * wcfg.NRANKS


def test_rank_major_layout_keeps_each_rank_in_one_real_row(ranks):
    """initialize_multihost's rank-major mesh, as the JAX pod mesh: rank r
    owns real row r whole (the port's ``cross`` layout is the one whose
    psr gather and toa psum cross ranks)."""
    got = np.asarray(ranks[0]["rank_major_ranks"])
    assert got.shape == (2, 2, 2)
    assert (got[0] == 0).all() and (got[1] == 1).all()


def test_reference_rank_major_mesh_crosses_no_process_in_a_row():
    """The JAX multihost worker's global (2, 2, 2) mesh reshapes the
    process-major device list, so each process's four devices fill one real
    row: within a row no collective crosses processes, although its
    docstring says the psr all_gather and the toa psum do. Shown on the
    conftest's eight devices with device i in process i // 4, the order
    ``jax.devices()`` lists two 4-device processes in."""
    devs = jax.devices()
    mesh = jax_mesh(devs, psr_shards=cfg.PSR_SHARDS,
                    toa_shards=cfg.TOA_SHARDS)
    proc = np.vectorize(lambda d: devs.index(d) // 4)(mesh.devices)
    assert proc.shape == (2, 2, 2)
    for row in proc:
        assert len(set(row.flat)) == 1


def test_to_host_gathers_the_real_blocks_in_shard_order(ranks):
    both = [[0.0] * 3] * 2 + [[1.0] * 3] * 2
    for r in range(wcfg.NRANKS):
        got = ranks[r]["to_host"]
        assert got["world"] == both and got["real"] == both
        # real 1 x psr 2: rank 0 leads the one row, rank 1 leads none
        assert got["psr"] == [[0.0] * 3] * 2


def test_checkpoint_files_on_rank_0_only_and_resume(ranks):
    r0, r1 = ranks[0], ranks[1]
    assert any(files for files in r0["ckpt_files_mid_run"])
    assert all(not files for files in r1["ckpt_files_mid_run"])
    # the finished run deleted its checkpoint (rank 0 again)
    assert r0["ckpt_files_after"] == [] and r1["ckpt_files_after"] == []
    # the cut run left the first chunk in the shared directory, and both
    # ranks resumed from it to the uninterrupted result
    assert r0["ckpt_shared_after_cut"] == ["mc", "mc.c000000.npz"]
    for r in (r0, r1):
        assert json.dumps(_plain(r["resumed"])) == json.dumps(
            _plain(r["uninterrupted"]))
    assert json.dumps(_plain(r0["resumed"])) == json.dumps(
        _plain(r1["resumed"]))


@pytest.mark.parametrize("kind,dirname", [("engine", "shards"),
                                          ("sampler", "sample_shards")])
def test_eventlog_shards_merge_into_pid_lanes(ranks, kind, dirname):
    shards = sorted((ranks["dir"] / dirname).glob("events-p*.jsonl"))
    assert [s.name for s in shards] == ["events-p000.jsonl",
                                        "events-p001.jsonl"]
    reports = [RunReport.load(s) for s in shards]
    assert [r.meta["process_index"] for r in reports] == [0, 1]
    assert all(r.meta["process_count"] == 2 for r in reports)
    trace = build_trace(reports)
    validate_trace(trace)
    assert {ev["pid"] for ev in trace["traceEvents"]} == {0, 1}
    for pid in (0, 1):
        names = {ev["name"] for ev in trace["traceEvents"]
                 if ev["pid"] == pid and ev["ph"] == "X"}
        assert "dispatch" in names, (pid, sorted(names))


@pytest.fixture(scope="module")
def jax_sampler():
    import jax.numpy as jnp

    jb = JaxBatch.synthetic(**wcfg.SAMPLE_BATCH, dtype=jnp.float64)
    study = JRun(jb, JSpec(model=wcfg.sample_model(jinfer),
                           **wcfg.SAMPLE_SPEC),
                 mesh=jax_mesh(jax.devices()[:1]), data_seed=1,
                 truth=np.array(wcfg.SAMPLE_TRUTH))
    return study.run(wcfg.SAMPLE_STEPS, pipeline_depth=0, **wcfg.SAMPLE_RUN)


@pytest.mark.parametrize("name", ["real2", "psr2", "toa_cross",
                                  "toa_only"])
def test_sampler_chains_bit_identical_and_match_jax(ranks, jax_sampler,
                                                    name):
    """``toa_cross``: real 2 x psr 2 x toa 2 on the cross layout;
    ``toa_only``: real 1 x toa 2, rank 1 owning only the toa 1 entry,
    held to the toa_cross one-process run (the chains do not depend on the
    mesh)."""
    got = [ranks[r]["sample"][name] for r in range(wcfg.NRANKS)]
    ref = ranks[0]["sample_ref"][
        "toa_cross" if name == "toa_only" else name]["theta"]
    for r, g in enumerate(got):
        assert json.dumps(g["theta"]) == json.dumps(ref), (name, r)
        assert g["meta"]["process_index"] == r
        assert g["meta"]["process_count"] == wcfg.NRANKS
        assert g["diag"] == got[0]["diag"]
    theta = np.asarray(got[0]["theta"])
    assert theta.shape == jax_sampler["theta"].shape
    np.testing.assert_allclose(theta, jax_sampler["theta"], rtol=1e-9,
                               atol=0)
    for k in ("accept_rate_by_temp", "swap_rate", "divergences",
              "nonfinite_lnl", "n_kept"):
        assert got[0]["diag"][k] == jax_sampler["diag"][k], k


# -- the stream ---------------------------------------------------------------

STREAM_CASES = tuple(wcfg.STREAM_CASES)
STREAM_KEYS = ("moments", "lnl", "restaged", "os", "detections",
               "os_sequence_snr")


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-300))


@pytest.fixture(scope="module")
def jax_stream():
    """The JAX stream over the workers' template (crossed as numpy) and
    blocks, with its OS per append."""
    tb = PulsarBatch.synthetic(**wcfg.STREAM_TEMPLATE,
                               dtype=torch.float64,
                               device="cpu")
    jt = JaxBatch(**{k: jax.numpy.asarray(v) for k, v in tb.numpy().items()})
    st = JaxStream(jt, jax_stream_model(nbin=wcfg.STREAM_NBIN),
                   ecorr_dt=wcfg.STREAM_ECORR_DT, watch="hd")
    infos = [st.append(b["t"], b["r"], sigma2=b["s2"], ecorr_amp=b["ec"],
                       counts=b["counts"]) for b in wcfg.stream_blocks()]
    return {"stream": st, "infos": infos,
            "moments": [np.asarray(x) for x in st.moments()],
            "lnl": st.lnlike(st.theta_ref), "pos": np.asarray(jt.pos)}


@pytest.mark.parametrize("case", STREAM_CASES)
def test_stream_bit_identical_to_the_one_process_mesh(ranks, case):
    ref = ranks[0]["stream_ref"][case]
    for r in range(wcfg.NRANKS):
        got = ranks[r]["stream"][case]
        for key in STREAM_KEYS:
            assert json.dumps(got[key]) == json.dumps(ref[key]), (case, r,
                                                                  key)


@pytest.mark.parametrize("case", STREAM_CASES)
def test_stream_matches_the_jax_stream(ranks, jax_stream, case):
    got = ranks[1]["stream"][case]
    for g, w in zip(got["moments"], jax_stream["moments"]):
        assert _rel_err(g, w) <= 1e-10
    assert abs(got["lnl"] - jax_stream["lnl"]) <= \
        1e-10 * abs(jax_stream["lnl"])
    for g, w in zip(got["os"], jax_stream["infos"]):
        for key in ("amp2", "snr"):
            assert np.isfinite(g[key])
            assert abs(g[key] - w[key]) <= 1e-9 * abs(w[key]), key
    # the detection sequence at the workers' threshold
    js = jax_stream["stream"]
    watcher = JaxOS(js._compiled, js._nsb, jax_stream["pos"],
                    theta_ref=js.theta_ref,
                    threshold_sigma=4.0 * got["os"][-1]["snr"])
    mom = js.moments()
    with jobs.collect() as col:
        for k in wcfg.OS_SCALES:
            watcher.update(mom[:4] + (mom[4] * k,))
    assert got["detections"] == col.counters.get("stream.detections", 0) \
        >= 1
    assert got["os_sequence_snr"] == pytest.approx(watcher.last["snr"],
                                                   rel=1e-9)


def test_stream_checkpoint_on_rank_0_only_and_resume(ranks):
    assert ranks[0]["stream_ckpt_files"] == [
        "s.ckpt", "s.ckpt.b000000.npz", "s.ckpt.b000001.npz",
        "s.ckpt.b000002.npz"]
    assert ranks[1]["stream_ckpt_files"] == []
    want = json.dumps(ranks[0]["stream"]["psr"]["moments"])
    for r in range(wcfg.NRANKS):
        got = ranks[r]["stream_resume"]
        assert got["replayed"] == 2
        assert json.dumps(got["moments"]) == want, r


def test_stream_refreshers_bit_identical_to_the_one_process_mesh(ranks):
    ref = ranks[0]["refresh_ref"]
    assert ref["promoted"] and ref["fs_lanes"] == wcfg.FS_NBIN
    for r in range(wcfg.NRANKS):
        assert json.dumps(ranks[r]["refresh"]) == json.dumps(ref), r


# -- the tuner's search ------------------------------------------------------

def _global_fingerprint():
    return tune.Fingerprint(platform="cpu", device_kind="cpu",
                            n_devices=wcfg.NRANKS,
                            n_processes=wcfg.NRANKS, hbm_bytes=0,
                            torch_version=str(torch.__version__),
                            cuda_version=str(torch.version.cuda or ""))


def test_search_one_config_on_every_rank_and_warm(ranks):
    got = [ranks[r]["search"] for r in range(wcfg.NRANKS)]
    for r, g in enumerate(got):
        assert g["cfg"] == got[0]["cfg"], r
        assert g["probes"] == len(g["probed"]) >= 1
        assert g["store_files"] == ["tuned.json"]
        assert g["store_path"] == got[0]["store_path"]
        # a second search on the same store: warm, no probe, same config
        assert g["warm"]["warm"] and g["warm"]["probes"] == 0
        assert g["warm"]["cfg"] == got[0]["cfg"]
    # the lead alone wrote the artifact
    assert [g["artifact"] for g in got] == [True, False]
    stored = json.loads(pathlib.Path(got[0]["store_path"]).read_text())
    assert list(stored["entries"].values()) == [got[0]["cfg"]]


def test_search_probes_the_global_fingerprints_frontier(ranks):
    fp = _global_fingerprint()
    tb = PulsarBatch.synthetic(**cfg.SIM, device="cpu")
    f = np.arange(1, cfg.GWB["ncomp"] + 1) / float(tb.tspan_common)
    psd = spectrum_lib.powerlaw(f, log10_A=cfg.GWB["log10_A"],
                                gamma=cfg.GWB["gamma"]).numpy()
    surf = EnsembleSimulator(tb, gwb=GWBConfig(psd=psd, orf="hd"),
                             device="cpu").dispatch_surface()
    kw = dict(wcfg.SEARCH)
    frontier = tune.candidate_frontier(
        fp, surf["npsr"], surf["max_toa"], surf["k_coef"],
        nreal_hint=kw["nreal_hint"], n_devices=wcfg.NRANKS * wcfg.LOCAL,
        dtype_bytes=surf["dtype_bytes"],
        max_candidates=kw["max_candidates"])
    for r in range(wcfg.NRANKS):
        got = ranks[r]["search"]
        assert got["fingerprint"] == fp.as_dict()
        assert got["cfg"]["fingerprint"] == fp.as_dict()
        assert got["probed"] == [c.knobs() for c in frontier], r


# -- faults on one rank --------------------------------------------------------

@pytest.mark.parametrize("what,own", [("stream_fault", "TransientFault"),
                                      ("search_fault", "FatalFault")])
def test_a_fault_on_one_rank_raises_on_every_rank(ranks, what, own):
    """A fault injected on rank 1 alone, at its stream append's or its
    first probe's site, raises there and raises RankFailure on rank 0,
    both within a second (the group's timeout is 60 s); neither rank's
    stream moved, so the retried appends land as if nothing failed."""
    r0, r1 = ranks[0][what], ranks[1][what]
    assert r1["raised"] == own, r1
    assert r0["raised"] == "RankFailure" and "rank 1" in r0["error"], r0
    assert max(r0["after_s"], r1["after_s"]) < 1.0
    if what == "stream_fault":
        want = json.dumps(ranks[0]["stream"]["psr"]["moments"])
        for r in (r0, r1):
            assert json.dumps(r["moments"]) == want


def test_a_rank_failure_raises_on_every_rank(ranks):
    """A transient fault injected on rank 1 alone is not retried there
    (rank 0 would wait in the psr gather): rank 1 raises it, and rank 0's
    collective fails once rank 1 is gone, well inside the group's 60 s
    timeout."""
    r0, r1 = ranks[0]["recovery"], ranks[1]["recovery"]
    assert r1["raised"] == "TransientFault", r1
    assert r0["raised"] == "RuntimeError", r0
    assert r0["after_s"] < 30.0
