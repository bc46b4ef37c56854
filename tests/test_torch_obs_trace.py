"""The port's run-timeline export (``fakepta_tpu_torch.obs.trace``) and the
``obs`` CLI's ``summarize`` / ``compare`` / ``trace`` against the JAX
package's, on the same saved report files (the engine-free cases of
tests/test_obs_trace.py and tests/test_obs.py).

Both packages read each file with their own ``RunReport.load``; traces
are compared after naming the tool alike (the port labels its lanes
``fakepta_tpu_torch``).
"""

import importlib
import json
import time

import jax
import numpy as np
import pytest

from fakepta_tpu import obs as jobs
from fakepta_tpu import spectrum as jspectrum
from fakepta_tpu.batch import PulsarBatch as JaxBatch
from fakepta_tpu.obs import cli as jcli
from fakepta_tpu.parallel.mesh import make_mesh as jax_mesh
from fakepta_tpu.parallel.montecarlo import EnsembleSimulator as JaxSim
from fakepta_tpu.parallel.montecarlo import GWBConfig as JaxGWB
from fakepta_tpu_torch import spectrum as spectrum_lib
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.obs import cli
from fakepta_tpu_torch.obs import trace
from fakepta_tpu_torch.obs.report import RunReport
from fakepta_tpu_torch.parallel.montecarlo import (EnsembleSimulator,
                                                   GWBConfig)

# the JAX package's attribute ``obs.trace`` is its profiler context manager,
# so the exporter module is imported by its path
jtrace = importlib.import_module("fakepta_tpu.obs.trace")
BATCH_KW = dict(npsr=4, ntoa=48, tspan_years=10.0, toaerr=1e-7, n_red=4,
                n_dm=4, seed=3)


def _alike(obj):
    """A trace or CLI text with the port's tool name read as the JAX
    package's."""
    text = obj if isinstance(obj, str) else json.dumps(obj, sort_keys=True)
    return text.replace("fakepta_tpu_torch", "fakepta_tpu")


def _slow_sink(done, nreal):
    time.sleep(0.05)     # on the writer thread: drains overlap executes


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Saved reports: the port's pipelined run, a second port run, the JAX
    engine's pipelined run, and a two-rank pair of shards."""
    d = tmp_path_factory.mktemp("torch_obs_trace")
    batch = PulsarBatch.synthetic(**BATCH_KW, device="cpu")
    f = np.arange(1, 5) / float(batch.tspan_common)
    psd = spectrum_lib.powerlaw(f, log10_A=-13.5, gamma=13 / 3).numpy()
    sim = EnsembleSimulator(batch, gwb=GWBConfig(psd=psd), device="cpu")
    paths = {}
    out = sim.run(24, seed=5, chunk=8, progress=_slow_sink)
    paths["port"] = out["report"].save(d / "port.jsonl")
    paths["port_b"] = sim.run(24, seed=6, chunk=8)["report"].save(
        d / "port_b.jsonl")
    jb = JaxBatch.synthetic(**BATCH_KW)
    jpsd = np.asarray(jspectrum.powerlaw(f, log10_A=-13.5, gamma=13 / 3))
    jsim = JaxSim(jb, gwb=JaxGWB(psd=jpsd, orf="hd"),
                  mesh=jax_mesh(jax.devices()[:1]))
    paths["jax"] = jsim.run(24, seed=5, chunk=8, progress=_slow_sink)[
        "report"].save(d / "jax.jsonl")
    rep1 = RunReport.load(paths["port"])
    rep1.meta = dict(rep1.meta, process_index=1, process_count=2)
    paths["shard1"] = rep1.save(d / "events-p001.jsonl")
    return paths


@pytest.mark.parametrize("which", ["port", "jax"])
def test_build_trace_equals_the_jax_trace(files, which):
    path = files[which]
    got = trace.build_trace([RunReport.load(path)])
    want = jtrace.build_trace([jobs.RunReport.load(path)])
    trace.validate_trace(got)
    assert _alike(got) == _alike(want)
    assert {e["ph"] for e in got["traceEvents"]} <= {"X", "i", "M"}
    names = {e["args"]["name"] for e in got["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"main", "device", "writer"} <= names


@pytest.mark.parametrize("which", ["port", "jax"])
def test_overlap_s_equals_jax(files, which):
    path = files[which]
    got = trace.overlap_s(RunReport.load(path), "drain", "execute")
    assert got == jtrace.overlap_s(jobs.RunReport.load(path), "drain",
                                   "execute")
    if which == "port":
        # the pipelined port run: each 50 ms drain hides a later execute
        assert got > 0.03


def test_shard_merge_assigns_pid_lanes_as_jax(files):
    shards = [files["port"], files["shard1"]]
    got = trace.build_trace(trace.load_reports(shards))
    want = jtrace.build_trace(jtrace.load_reports(shards))
    assert _alike(got) == _alike(want)
    assert {e["pid"] for e in got["traceEvents"]} == {0, 1}
    # the same shard twice (both pid 0): lanes are not stacked
    twice = trace.build_trace(trace.load_reports([files["port"]] * 2))
    assert len({e["pid"] for e in twice["traceEvents"]}) == 2
    assert trace.timeline_events(RunReport.load(files["port"]))[0][
        "name"] == "process_name"


def test_flow_events_link_trace_ids_as_jax():
    rep_a, rep_b = RunReport(meta={"process_index": 0}), \
        RunReport(meta={"process_index": 1})
    rep_a.timeline = [
        {"name": "route", "tid": "router", "t0": 0.1, "dur": 0.2,
         "trace_id": "t1"},
        {"name": "cohort", "tid": "serve", "t0": 0.4, "dur": 0.1,
         "trace_ids": ["t1", "t2"]},
        {"name": "mark", "tid": "main", "t0": 0.5, "dur": None,
         "trace_id": "t1"}]
    rep_b.timeline = [
        {"name": "dispatch", "tid": "main", "t0": 0.3, "dur": 0.05,
         "trace_id": "t2"},
        {"name": "dispatch", "tid": "main", "t0": 0.6, "dur": 0.05,
         "trace_id": "t1"}]
    j_a, j_b = jobs.RunReport(meta=rep_a.meta), jobs.RunReport(
        meta=rep_b.meta)
    j_a.timeline, j_b.timeline = rep_a.timeline, rep_b.timeline
    got = trace.build_trace([rep_a, rep_b])
    trace.validate_trace(got)
    assert _alike(got) == _alike(jtrace.build_trace([j_a, j_b]))
    assert got["metadata"]["flows"] == 5     # links: 3 for t1, 2 for t2


@pytest.mark.parametrize("bad,match", [
    ({"foo": 1}, "traceEvents"),
    ({"traceEvents": ["x"]}, "object"),
    ({"traceEvents": [{"ph": "Z", "pid": 0, "tid": 0, "name": "x"}]}, "ph"),
    ({"traceEvents": [{"ph": "X", "pid": 0, "tid": 0, "name": ""}]},
     "name"),
    ({"traceEvents": [{"ph": "X", "pid": "0", "tid": 0, "name": "x"}]},
     "pid"),
    ({"traceEvents": [{"ph": "M", "pid": 0, "tid": 0, "name": "x"}]},
     "args"),
    ({"traceEvents": [{"ph": "X", "pid": 0, "tid": 0, "name": "x",
                       "ts": -1}]}, "ts"),
    ({"traceEvents": [{"ph": "X", "pid": 0, "tid": 0, "name": "x",
                       "ts": 0.0}]}, "dur"),
    ({"traceEvents": [{"ph": "s", "pid": 0, "tid": 0, "name": "x",
                       "ts": 0.0}]}, "id"),
], ids=["no-list", "not-object", "ph", "name", "pid", "meta-args", "ts",
        "dur", "flow-id"])
def test_validate_trace_rejects_what_jax_rejects(bad, match):
    with pytest.raises(ValueError, match=match) as got:
        trace.validate_trace(bad)
    with pytest.raises(ValueError) as want:
        jtrace.validate_trace(bad)
    assert str(got.value) == str(want.value)


def _run_cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("which", ["port", "jax"])
def test_cli_trace_writes_the_jax_file(files, which, tmp_path, capsys):
    shards = [files[which], files["shard1"]]
    rc, out, _ = _run_cli(cli.main, ["trace", *map(str, shards), "-o",
                                     str(tmp_path / "a.json")], capsys)
    jrc, jout, _ = _run_cli(jcli.main, ["trace", *map(str, shards), "-o",
                                        str(tmp_path / "b.json")], capsys)
    assert rc == jrc == 0
    assert "2 process lane(s)" in out and "perfetto" in out
    assert _alike(json.loads((tmp_path / "a.json").read_text())) == \
        _alike(json.loads((tmp_path / "b.json").read_text()))
    assert out.replace("a.json", "b.json") == jout


@pytest.mark.parametrize("args", [
    ["summarize", "{port}"], ["summarize", "{jax}"],
    ["summarize", "{port}", "--format", "json"],
    ["summarize", "{port}", "{shard1}"],
    ["summarize", "{port}", "{shard1}", "--format", "json"],
    ["compare", "{port}", "{port_b}"],
    ["compare", "{port}", "{port_b}", "--rel-threshold", "0.0",
     "--fail-on-regression"],
], ids=["summarize", "summarize-jax-file", "summarize-json", "interleave",
        "interleave-json", "compare", "compare-gate"])
def test_cli_output_equals_jax(files, args, capsys):
    argv = [a.format(**{k: str(v) for k, v in files.items()}) for a in args]
    rc, out, _ = _run_cli(cli.main, argv, capsys)
    jrc, jout, _ = _run_cli(jcli.main, argv, capsys)
    assert rc == jrc
    assert out == jout


def test_cli_usage_errors_exit_2(tmp_path, capsys):
    missing = str(tmp_path / "nope.jsonl")
    rc, _, err = _run_cli(cli.main, ["summarize", missing], capsys)
    assert rc == 2 and "error" in err
    rc, _, _ = _run_cli(cli.main, ["compare", missing, missing], capsys)
    assert rc == 2
    # gate / top / alerts (ported since): a missing file is an I/O error,
    # exit 2 as in the JAX CLI
    for verb in ("gate", "top", "alerts"):
        rc, _, err = _run_cli(cli.main, [verb, missing], capsys)
        jrc, _, _ = _run_cli(jcli.main, [verb, missing], capsys)
        assert rc == jrc == 2 and "error" in err
