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
wrong, ROADMAP Queue 3). Only rank 0 writes checkpoint files, a cut run resumes from a
shared directory to the uninterrupted one, the event-log shards merge
into one trace with pid lanes {0, 1}, the 2-rank sampler's chains equal
the one-process run bit for bit and the JAX sampler's at 1e-9 (float64),
and a fault on one rank raises on both instead of hanging.

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
import numpy as np
import pytest

import _multihost_worker as cfg
import _torch_multiproc_worker as wcfg
from fakepta_tpu import infer as jinfer
from fakepta_tpu.batch import PulsarBatch as JaxBatch
from fakepta_tpu.detect import OSSpec as JaxOSSpec
from fakepta_tpu.parallel.mesh import make_mesh as jax_mesh
from fakepta_tpu.sample import SampleSpec as JSpec
from fakepta_tpu.sample import SamplingRun as JRun
from fakepta_tpu_torch import infer
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
    theta = jinfer.theta_grid(wcfg.lnl_model(jinfer), wcfg.THETA_SHAPE)
    return {
        "cross": sim(2, 2).run(nreal, keep_corr=True, **run),
        "psr2": psr2.run(nreal, **run),
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
    layout, _, _, rkw = wcfg.CASES[case]
    want = jax_runs["cross" if layout in ("cross", "rank_major")
                    else "os" if "os" in rkw else "psr2"]
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


def test_stream_refuses_a_multi_process_mesh(ranks):
    for r in range(wcfg.NRANKS):
        assert "one process's mesh" in (ranks[r]["stream_refused"] or "")


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


@pytest.mark.parametrize("name", ["real2", "psr2"])
def test_sampler_chains_bit_identical_and_match_jax(ranks, jax_sampler,
                                                    name):
    got = [ranks[r]["sample"][name] for r in range(wcfg.NRANKS)]
    ref = ranks[0]["sample_ref"][name]["theta"]
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


def test_a_rank_failure_raises_on_every_rank(ranks):
    """A transient fault injected on rank 1 alone is not retried there
    (rank 0 would wait in the psr gather): rank 1 raises it, and rank 0's
    collective fails once rank 1 is gone, well inside the group's 60 s
    timeout."""
    r0, r1 = ranks[0]["recovery"], ranks[1]["recovery"]
    assert r1["raised"] == "TransientFault", r1
    assert r0["raised"] == "RuntimeError", r0
    assert r0["after_s"] < 30.0
