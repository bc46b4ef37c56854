"""The port's socket fleet (``SocketReplica`` subprocesses running ``python
-m fakepta_tpu_torch.serve replica --device cpu``) and the fleet CLI, on
the CPU.

One module-scoped fleet of two socket replicas (started once; each takes
this process's torch thread count, so its float sums are the router's)
serves, in order (tests/test_fleet.py:386-503 and
tests/test_lifecycle.py:234-330):

- a two-replica smoke: both specs served, each response bit for bit the
  router's own solo run, no steady build, no nvcc started, the two
  replicas counted as one chip;
- a ``sample`` session over one replica's socket streaming its segments,
  each equal bit for bit to the same session run in this process;
- the stream lines (``append`` opening a stream, ``stream``, ``cutover``)
  over a replica's socket;
- the ``replica --register`` handshake: a replica subprocess dials the
  router's admin port, is adopted, serves bit-identically and retires;
- ``Autoscaler.step`` joining a replica and then retiring it;
- last, a SIGKILL of one replica under load: nothing lost, every response
  bit for bit its solo run.

Then the CLI: ``fleet`` and ``loadgen --fleet`` print their rows, and a
replica exits instead of answering when a failure poisons its process.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from fakepta_tpu_torch.parallel.mesh import make_mesh
from fakepta_tpu_torch.serve import (ArraySpec, AutoscaleConfig, Autoscaler,
                                     FleetConfig, HealthConfig, LocalReplica,
                                     SampleSessionSpec, ServeConfig,
                                     ServeFleet, SimRequest, SocketReplica,
                                     cli)
from fakepta_tpu_torch.serve.fleet import build_session_run

ROOT = Path(__file__).resolve().parents[1]
SPEC_KW = dict(npsr=4, ntoa=32, n_red=3, n_dm=3, gwb_ncomp=3)
SPEC0 = ArraySpec(data_seed=100, **SPEC_KW)
SPEC1 = dataclasses.replace(SPEC0, data_seed=101)
T_OUT = 300
HEALTH = HealthConfig(period_s=0.05, probe_deadline_s=2.0, suspect_after=3,
                      wedged_after=6, close_after=2, backoff_base_s=0.02,
                      backoff_cap_s=0.1)


def _wait_for(pred, timeout_s=60.0, step=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


@pytest.fixture(scope="module")
def sock_fleet():
    out = [None, None]
    errs = []

    def spawn(i):
        try:
            out[i] = SocketReplica(f"p{i}", spec_defaults=SPEC0,
                                   buckets=(8,), index=i, device="cpu")
        except Exception as exc:   # noqa: BLE001 — surfaced below
            errs.append(exc)

    threads = [threading.Thread(target=spawn, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(T_OUT)
    assert not errs and all(out), f"fleet startup failed: {errs!r}"
    flt = ServeFleet(out, FleetConfig())
    yield {"fleet": flt, "solo": SPEC0.build(device="cpu")}
    flt.close()


def test_socket_fleet_two_replica_smoke(sock_fleet):
    flt, sim = sock_fleet["fleet"], sock_fleet["solo"]
    a = flt.serve(SimRequest(spec=SPEC0, n=5, seed=11), timeout=T_OUT)
    b = flt.serve(SimRequest(spec=SPEC1, n=3, seed=22), timeout=T_OUT)
    a2 = flt.serve(SimRequest(spec=SPEC0, n=5, seed=11), timeout=T_OUT)
    assert a.replica == a2.replica == flt.ring.owner(SPEC0.spec_hash())
    assert b.replica == flt.ring.owner(SPEC1.spec_hash())
    alone = sim.run(8, chunk=8, lanes=[(11, 5)], pipeline_depth=0)
    assert np.array_equal(a.curves, alone["curves"][:5])
    assert np.array_equal(a.autos, alone["autos"][:5])
    assert np.array_equal(a2.curves, a.curves)
    assert b.curves.shape == (3, SPEC1.nbins)
    slo = flt.slo_summary()
    assert slo["fleet_steady_compiles"] == 0 and slo["fleet_requests"] == 3
    assert flt.n_chips == 1                  # both replicas on "cpu"
    for r in flt.replicas.values():
        assert r.device_ids() == ("cpu",)
        assert r.kernel_summary()["nvcc_starts"] == 0
        assert r.ping(5.0) and "slo" in r.telemetry(5.0)


def _ask_lines(port, obj, until):
    """Send one line; read reply lines until ``until(reply)``."""
    with socket.create_connection(("127.0.0.1", port), timeout=T_OUT) as c:
        c.settimeout(T_OUT)
        c.sendall((json.dumps(obj) + "\n").encode())
        rfile = c.makefile("rb")
        lines = []
        while True:
            raw = rfile.readline(8 * 1024 * 1024)
            assert raw, "connection closed before the last line"
            lines.append(json.loads(raw))
            if until(lines[-1]):
                return lines


def test_socket_sample_session_streams_segments(sock_fleet, tmp_path):
    """The ``sample`` kind: one line per drained segment, then the summary
    line; the streamed draws equal the same session run here."""
    rep = sock_fleet["fleet"].replicas["p0"]
    session = {"nbin": 2, "n_chains": 4, "warmup": 4, "n_leapfrog": 3}
    lines = _ask_lines(rep.port, {
        "id": 1, "kind": "sample", "steps": 8, "seed": 3, "segment": 4,
        "spec": dataclasses.asdict(SPEC0), "session": session,
        "checkpoint": str(tmp_path / "ck")}, lambda m: m.get("done"))
    assert all(m["ok"] for m in lines)
    segs = [m for m in lines if "seg" in m]
    assert segs and all("theta" in m for m in segs)
    done = lines[-1]
    assert done["n_kept"] == sum(m["n"] for m in segs)
    assert "rhat_max" in done["summary"]
    sess = SampleSessionSpec(spec=SPEC0, n_steps=8, seed=3, segment=4,
                             **session)
    want = build_session_run(sess, make_mesh(["cpu"])).run(
        8, seed=3, segment=4, pipeline_depth=0)
    got = np.concatenate([np.asarray(m["theta"]) for m in segs])
    np.testing.assert_array_equal(got, want["theta"])


def test_socket_stream_and_cutover_lines(sock_fleet):
    rep = sock_fleet["fleet"].replicas["p1"]
    spec = dict(SPEC_KW, tspan_years=3.0)
    rng = np.random.default_rng(4)
    t = np.sort(rng.uniform(0.0, 8e7, (4, 4)), axis=1)
    r = rng.normal(0.0, 1e-7, (4, 4))
    first = _ask_lines(rep.port, {
        "id": 1, "kind": "append", "stream": "w0", "toas": t.tolist(),
        "residuals": r.tolist(), "spec": spec}, lambda m: True)[0]
    assert first["ok"] and first["stream"]["n_toas"] == 16
    cut = _ask_lines(rep.port, {
        "id": 2, "kind": "cutover", "stream": "w0",
        "spec": dict(spec, tspan_years=4.0)}, lambda m: True)[0]
    assert cut["ok"] and cut["cutover"]["toas"] == 16
    stats = _ask_lines(rep.port, {"id": 3, "kind": "stream",
                                  "stream": "w0"}, lambda m: True)[0]
    assert stats["stream"]["n_toas"] == 16
    assert rep.stats()["serve_requests"] >= 0
    bad = _ask_lines(rep.port, {"id": 4, "kind": "cutover", "stream": "w9",
                                "spec": spec}, lambda m: True)[0]
    assert not bad["ok"] and "not open" in bad["error"]


def test_replica_register_handshake_adopts_and_serves(sock_fleet):
    """``serve replica --register HOST:PORT`` dials the router's admin
    port and is adopted through SocketReplica attach mode; the fleet's
    health plane probes it; traffic keeps verifying; retire removes it."""
    import torch

    flt = sock_fleet["fleet"]
    ref = flt.serve(SimRequest(spec=SPEC1, n=3, seed=33), timeout=T_OUT)
    admin_port = flt.listen()
    flt.enable_health(HEALTH)
    proc = subprocess.Popen(
        [sys.executable, "-m", "fakepta_tpu_torch.serve", "replica",
         "--port", "0", "--host", "127.0.0.1", "--device", "cpu",
         "--threads", str(torch.get_num_threads()),
         "--npsr", str(SPEC1.npsr), "--ntoa", str(SPEC1.ntoa),
         "--n-red", str(SPEC1.n_red), "--n-dm", str(SPEC1.n_dm),
         "--gwb-ncomp", str(SPEC1.gwb_ncomp), "--buckets", "8",
         "--register", f"127.0.0.1:{admin_port}", "--replica-id", "joiner"],
        cwd=ROOT, env=_env(), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        assert _wait_for(lambda: "joiner" in flt.replicas, timeout_s=120.0), \
            "the adopt handshake never completed"
        assert flt.replicas["joiner"].alive
        assert _wait_for(lambda: flt.health.state("joiner") == "healthy")
        assert flt.slo_summary()["fleet_joins"] >= 1
        again = flt.serve(SimRequest(spec=SPEC1, n=3, seed=33),
                          timeout=T_OUT)
        assert np.array_equal(again.curves, ref.curves)
        flt.retire("joiner")
        assert "joiner" not in flt.replicas
        back = flt.serve(SimRequest(spec=SPEC1, n=3, seed=33),
                         timeout=T_OUT)
        assert np.array_equal(back.curves, ref.curves)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def test_autoscaler_step_actuates_join_then_retire(sock_fleet):
    """An up decision spawns and joins exactly one replica, a down
    decision retires the newest join first, and the cooldown blocks a
    back-to-back change."""
    flt = sock_fleet["fleet"]
    flt.serve(SimRequest(spec=SPEC0, n=2, seed=5), timeout=T_OUT)
    spawned = []

    def spawn(index):
        r = LocalReplica(f"scale{index}", device="cpu", index=index,
                         config=ServeConfig(buckets=(8,)))
        spawned.append(r)
        return r

    n0 = len(flt.replicas)
    up = Autoscaler(flt, spawn, AutoscaleConfig(
        min_replicas=1, max_replicas=4, target_qps_per_replica=1e-9,
        p99_high_ms=1e12, p99_low_ms=0.0, cooldown_s=0.0))
    d = up.step()
    assert d["action"] == "up" and len(spawned) == 1
    assert spawned[0].id in flt.replicas and up.scale_events == 1
    down = Autoscaler(flt, spawn, AutoscaleConfig(
        min_replicas=1, max_replicas=4, target_qps_per_replica=1e12,
        p99_high_ms=1e12, p99_low_ms=1e12, cooldown_s=3600.0))
    d2 = down.step()
    assert d2["action"] == "down" and d2["replica"] == spawned[0].id
    assert spawned[0].id not in flt.replicas and not spawned[0].alive
    assert down.step()["action"] == "cooldown"
    assert len(flt.replicas) == n0


def test_socket_fleet_kill_failover_loses_nothing(sock_fleet):
    """SIGKILL the first spec's owner mid-stream: every accepted request
    completes (failed over through the reader's EOF), each bit for bit
    its solo run, and later traffic routes around the dead replica."""
    flt, sim = sock_fleet["fleet"], sock_fleet["solo"]
    victim = flt.ring.owner(SPEC0.spec_hash())
    futs = [flt.submit(SimRequest(spec=SPEC0, n=4, seed=100 + i))
            for i in range(3)]
    flt.replicas[victim].kill()
    futs += [flt.submit(SimRequest(spec=SPEC0, n=4, seed=103 + i))
             for i in range(3)]
    results = [f.result(timeout=T_OUT) for f in futs]
    assert flt.slo_summary()["fleet_replica_deaths"] >= 1
    assert any(r.failovers for r in results)
    for i, r in enumerate(results):
        alone = sim.run(r.bucket, chunk=r.bucket, lanes=[(100 + i, 4)],
                        pipeline_depth=0)
        assert np.array_equal(r.curves, alone["curves"][:4]), (
            f"request {i} (replica {r.replica}, failovers {r.failovers})")
    again = flt.serve(SimRequest(spec=SPEC0, n=4, seed=7), timeout=T_OUT)
    assert again.replica != victim


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

TINY = ["--device", "cpu", "--npsr", "4", "--ntoa", "32", "--n-red", "3",
        "--n-dm", "3", "--gwb-ncomp", "3", "--buckets", "8"]


def test_cli_fleet_inproc_row(capsys):
    assert cli.main(["fleet", "--transport", "inproc", "--replicas", "2",
                     "--requests", "8", "--sizes", "1", "2", "--specs", "2",
                     "--verify", "1", "--kill-one-at", "0.5", *TINY]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["fleet_requests"] == 8 and row["fleet_lost_requests"] == 0
    assert row["fleet_transport"] == "inproc" and row["fleet_failovers"] >= 0
    assert row["fleet_replica_deaths"] == 1


def test_cli_loadgen_fleet_spawns_socket_replicas(capsys):
    assert cli.main(["loadgen", "--fleet", "2", "--requests", "6",
                     "--sizes", "1", "2", "--verify", "1", *TINY]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["fleet_transport"] == "process"
    assert row["fleet_requests"] == 6 and row["fleet_lost_requests"] == 0
    assert set(row["fleet_ready_s"]) == {"r0", "r1"}
    assert row["fleet_devices"] == ["cpu"] and row["fleet_verified"] >= 1


def test_replica_exits_when_a_failure_poisons_its_process(monkeypatch):
    """A dispatch failure naming a sticky CUDA error (or a failed kernel
    build) ends a replica's process without an answer line, so its
    router fails the request over; any other failure is answered."""
    from fakepta_tpu_torch.faults.recovery import poisons_process
    from fakepta_tpu_torch.serve import ServePool

    sticky = RuntimeError("CUDA error: an illegal memory access was "
                          "encountered")
    wrapped = RuntimeError("dispatch failed")
    wrapped.__cause__ = RuntimeError("kernel build failed:\n--- x ---")
    assert poisons_process(sticky) and poisons_process(wrapped)
    assert not poisons_process(RuntimeError("CUDA out of memory"))
    exited = []
    monkeypatch.setattr(cli, "_die_poisoned", exited.append)
    pool = ServePool(device="cpu", config=ServeConfig(buckets=(8,)))

    def boom(*a, **kw):
        raise sticky

    try:
        entry = pool._pool.get(SPEC0.spec_hash(), SPEC0)
        monkeypatch.setattr(entry.sim, "run", boom)
        out = []
        line = json.dumps({"id": 1, "kind": "sim", "n": 2, "seed": 1})
        cli._serve_stream(pool, [line], out.append, SPEC0, "full",
                          exit_on_poison=True)
        assert len(exited) == 1 and out == []
        cli._serve_stream(pool, [line], out.append, SPEC0, "full")
        assert json.loads(out[0])["code"] == "error"
    finally:
        pool.close()
