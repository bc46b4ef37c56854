"""The port's sampler within itself, and its CLI against the JAX CLI, on
the CPU: what the JAX tests hold bit for bit is held bit for bit (reruns,
the real-2 and psr-2 CPU meshes, pipeline depths 0-2, checkpoint kill and
resume, and the retried segment of the chaos lanes of
tests/test_faults.py). The fixtures (a float64 batch, the port's study and
its 1-shard depth-0 reference run, module-scoped here) are
tests/test_torch_sample.py's, which holds the port against the JAX
sampler.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from fakepta_tpu_torch import faults
from fakepta_tpu_torch.obs.report import RunReport
from fakepta_tpu_torch.parallel.mesh import make_mesh
from fakepta_tpu_torch.sample import SAMPLE_SCHEMA, cli
from test_torch_sample import (FAST, N_STEPS, RUN, _same, _study,  # noqa
                               jb, ref, study, tb)


# ---------------------------------------------------------------------------
# invariance within the port: reruns, meshes, depths, resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,depth", [
    ((1, 1), 1), ((1, 1), 2), ((2, 1), 0), ((1, 2), 2), ((2, 2), 1)],
    ids=["1x1-d1", "1x1-d2", "real2-d0", "psr2-d2", "real2xpsr2-d1"])
def test_meshes_and_depths_bit_identical(tb, ref, shape, depth):
    real, psr = shape
    mesh = (None if shape == (1, 1)
            else make_mesh(["cpu"] * (real * psr), psr_shards=psr))
    out = _study(tb, mesh=mesh).run(N_STEPS, pipeline_depth=depth, **RUN)
    _same(out, ref)
    assert out["report"].meta["mesh_shape"]["real"] == real
    assert out["report"].memory["packed_buffers_live_peak"] <= max(depth, 1)


def test_checkpoint_kill_resume_bit_identical(tb, ref, tmp_path):
    ck = tmp_path / "chains.json"

    class Stop(RuntimeError):
        pass

    def bomb(done, total):
        if done >= 16:
            raise Stop("cut")

    with pytest.raises(Stop):
        _study(tb).run(N_STEPS, checkpoint=ck, pipeline_depth=0,
                       progress=bomb, **RUN)
    assert ck.exists()
    manifest = json.loads(ck.read_text())
    assert manifest["schema"] == SAMPLE_SCHEMA and manifest["done"] == 2
    resumed = _study(tb, mesh=make_mesh(["cpu"] * 2)).run(
        N_STEPS, checkpoint=ck, pipeline_depth=2, **RUN)
    _same(resumed, ref)
    assert not list(tmp_path.glob("chains.json*"))


def test_init_z_on_segment_and_artifact(tb, study, tmp_path):
    seen = []
    out = study.run(N_STEPS, init_z=np.zeros((8, 2, 2)), pipeline_depth=2,
                    on_segment=lambda i, arr: seen.append((i, arr.shape)),
                    **RUN)
    assert seen == [(1, (4, 8, 2)), (2, (4, 8, 2))]
    assert study.last_z.shape == (8, 2, 2)
    art = study.save(tmp_path / "s.jsonl")
    rep = RunReport.load(art)
    assert rep.meta["sample_schema"] == SAMPLE_SCHEMA
    assert rep.summary()["rhat_max"] == out["summary"]["rhat_max"]
    names = {e["name"] for e in out["report"].timeline}
    assert names <= {"dispatch", "execute", "drain", "stall", "recycle",
                     "final_fetch"}
    with pytest.raises(ValueError, match="init_z"):
        study.run(N_STEPS, init_z=np.zeros((3, 2, 2)), **RUN)


def test_unported_options_raise(study, tmp_path):
    with pytest.raises(NotImplementedError, match="11b"):
        study.run(N_STEPS, tuned=True)
    # the event log is ported: one shard per process
    study.run(N_STEPS, eventlog=tmp_path / "ev", **RUN)
    shard = RunReport.load(tmp_path / "ev" / "events-p000.jsonl")
    assert shard.meta["process_index"] == 0
    assert shard.meta["process_count"] == 1
    with pytest.raises(NotImplementedError, match="11b"):
        study.warm_start(N_STEPS)
    with pytest.raises(TypeError, match="RecoveryPolicy"):
        study.run(N_STEPS, recovery="always")


# ---------------------------------------------------------------------------
# sample.segment: the chaos lanes (tests/test_faults.py:297-366)
# ---------------------------------------------------------------------------

def test_segment_transient_retry_bit_identical(study, ref):
    plan = faults.FaultPlan(
        [faults.FaultSpec("sample.segment", "transient", at=(1,))])
    with faults.inject(plan):
        out = study.run(N_STEPS, recovery=FAST, **RUN)
    assert plan.fired == [("sample.segment", "transient", 1)]
    _same(out, ref)
    assert out["report"].counters.get("faults.retries") == 1
    plan = faults.FaultPlan(
        [faults.FaultSpec("pipeline.writer", "transient", at=(0,))])
    with faults.inject(plan):
        out = study.run(N_STEPS, **RUN)          # the default policy
    _same(out, ref)


def test_segment_poison_fails_loud(study, tmp_path, monkeypatch):
    monkeypatch.setenv("FAKEPTA_TORCH_FLIGHTREC_DIR", str(tmp_path))
    plan = faults.FaultPlan(
        [faults.FaultSpec("sample.segment", "poison", at=(1,))])
    with faults.inject(plan):
        with pytest.raises(FloatingPointError, match="non-finite"):
            study.run(N_STEPS, recovery=FAST, **RUN)
    dumps = list(tmp_path.glob("flightrec-*.json"))
    assert dumps and "nan_lnl_abort" in dumps[0].read_text()


def test_segment_torn_ckpt_kill_restart_bit_identical(study, ref, tmp_path):
    ck = str(tmp_path / "sck.json")
    plan = faults.FaultPlan([faults.FaultSpec("ckpt.append", "torn",
                                              at=(2,))])
    with faults.inject(plan):
        with pytest.raises(faults.KillFault):
            study.run(N_STEPS, checkpoint=ck, recovery=FAST, **RUN)
    out = study.run(N_STEPS, checkpoint=ck, recovery=FAST, **RUN)
    _same(out, ref)
    assert not list(tmp_path.glob("sck.json*"))


def test_recovery_disabled_propagates(study):
    plan = faults.FaultPlan(
        [faults.FaultSpec("sample.segment", "transient", at=(0,))])
    with faults.inject(plan):
        with pytest.raises(faults.TransientFault):
            study.run(N_STEPS, recovery=False, **RUN)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI_ARGS = ["run", "--npsr", "4", "--ntoa", "48", "--nbin", "2",
            "--chains", "8", "--temps", "1", "--steps", "8", "--warmup",
            "4", "--thin", "2", "--segment", "4", "--n-leapfrog", "3"]


def test_cli_summary_against_the_jax_cli(tmp_path):
    """``python -m fakepta_tpu_torch.sample run`` prints the JAX CLI's
    summary row (same keys, same run description), its artifact loads,
    and it exits 2 on a configuration error and without a card."""
    from fakepta_tpu.sample import cli as jcli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jcli.main(CLI_ARGS) == 0
    want = json.loads(buf.getvalue().strip().splitlines()[-1])
    buf = io.StringIO()
    art = tmp_path / "s.jsonl"
    with contextlib.redirect_stdout(buf):
        assert cli.main(CLI_ARGS + ["--device", "cpu", "--out",
                                    str(art)]) == 0
    got = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert set(got) == set(want) | {"artifact"}
    for key in ("npsr", "chains", "temps", "steps", "model", "d"):
        assert got[key] == want[key], key
    assert np.isfinite(got["rhat_max"]) and 0 < got["accept_rate"] <= 1
    assert RunReport.load(art).meta["kind"] == "sample"
    assert cli.main(CLI_ARGS + ["--device", "cpu", "--chains", "1"]) == 2
    assert cli.build_parser().parse_args(["run"]).device == "cuda"
    if not torch.cuda.is_available():
        assert cli.main(CLI_ARGS) == 2
