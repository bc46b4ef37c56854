"""The port's serve protocol and CLI (``fakepta_tpu_torch.serve.cli``)
against the JAX package's, on the CPU.

The codecs (``request_from_json``, ``response_json``,
``request_to_json``, ``error_json``) are held equal to the JAX package's
on the same dicts; a ``stdin`` session runs through ``io.StringIO``; a
``socket`` server on ``127.0.0.1:0`` answers ``ping``, ``stats``,
``telemetry``, ``metrics`` and ``sim`` and feeds ``obs top`` / ``obs
alerts``; a ``replica`` subprocess prints its ready banner; the stream,
``sample`` and ``cutover`` kinds answer, and the fleet commands start
(without a card and without ``--device cpu`` they exit 2, as every entry
point does). One module-scoped port pool (4 pulsars x 32 TOAs, bucket 8)
serves every case.
"""

import argparse
import dataclasses
import io
import json
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from fakepta_tpu.serve import cli as jcli
from fakepta_tpu.serve.scheduler import ServeResult as JaxResult
from fakepta_tpu.serve.spec import ArraySpec as JaxSpec
from fakepta_tpu.serve.spec import ServeBusy as JaxBusy
from fakepta_tpu.serve.spec import ServeTimeout as JaxTimeout
from fakepta_tpu_torch.obs import cli as obs_cli
from fakepta_tpu_torch.serve import (ArraySpec, ServeBusy, ServeConfig,
                                     ServePool, ServeTimeout, SimRequest)
from fakepta_tpu_torch.serve import cli
from fakepta_tpu_torch.serve.scheduler import ServeResult

ROOT = Path(__file__).resolve().parents[1]
SPEC_KW = dict(npsr=4, ntoa=32, n_red=3, n_dm=3, gwb_ncomp=3)
SPEC = ArraySpec(**SPEC_KW)
JSPEC = JaxSpec(**SPEC_KW)

LINES = [
    {"id": 1, "n": 4, "seed": 9},
    {"id": 2, "kind": "os", "n": 2, "orf": "dipole", "null": True,
     "deadline_ms": 250, "trace_id": "t-2"},
    {"id": 3, "kind": "os", "n": 2, "orf": ["hd", "monopole"],
     "weighting": "none"},
    {"id": 4, "kind": "infer", "n": 2, "grid": {"k": 2, "nbin": 3}},
    {"id": 5, "kind": "sim", "n": 3, "seed": 2,
     "spec": dict(SPEC_KW, data_seed=3)},
    {"id": 6, "kind": "sim", "n": 1, "spec": "tenant"},
    {"id": 7, "kind": "append", "stream": "s0", "toas": [[1.0, 2.0]],
     "residuals": [[0.1, 0.2]], "spec": SPEC_KW, "ecorr_dt": 2.0e6,
     "watch": "hd", "checkpoint": "/tmp/x", "deadline_ms": 10},
    {"id": 8, "kind": "stream", "stream": "s0"},
]


@pytest.fixture(scope="module")
def pool():
    p = ServePool(device="cpu", config=ServeConfig(buckets=(8,),
                                                   coalesce_window_s=0.01))
    p.register("tenant", p._pool.get(SPEC.spec_hash(), SPEC).sim)
    yield p
    p.close()


def _fields(req):
    """A request's fields as plain data (specs and InferSpecs by value)."""
    out = {}
    for f in dataclasses.fields(req):
        v = getattr(req, f.name)
        if dataclasses.is_dataclass(v) and hasattr(v, "spec_dict"):
            v = v.spec_dict()
        elif f.name == "lnlike" and v is not None:
            v = (np.asarray(v.theta).tolist(), v.mode)
        elif isinstance(v, np.ndarray):
            v = v.tolist()
        out[f.name] = v
    return out


@pytest.mark.parametrize("line", LINES, ids=lambda d: str(d["id"]))
def test_request_codecs_equal_jax(line):
    """request_from_json builds the JAX package's request, field for
    field; request_to_json writes the JAX package's line for it."""
    got = cli.request_from_json(dict(line), SPEC)
    want = jcli.request_from_json(dict(line), JSPEC)
    assert type(got).__name__ == type(want).__name__
    assert _fields(got) == _fields(want)
    if got.kind in ("sim", "os"):
        assert got.lane_token() == want.lane_token()
    assert cli.request_to_json(got, line["id"]) == \
        jcli.request_to_json(want, line["id"])


def test_request_parse_errors_equal_jax():
    for bad in ({"kind": "wat", "n": 1}, {"kind": "sim"},
                {"kind": "sim", "n": 1, "spec": 3}):
        errs = []
        for mod, spec in ((cli, SPEC), (jcli, JSPEC)):
            with pytest.raises((ValueError, KeyError)) as exc:
                mod.request_from_json(dict(bad), spec)
            errs.append((type(exc.value), str(exc.value)))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("emit", ["summary", "full"])
def test_response_json_equals_jax(emit):
    rng = np.random.default_rng(0)
    arrays = dict(curves=rng.standard_normal((3, 15)),
                  autos=rng.random(3), bin_centers=np.linspace(0, 3, 15))
    os_ = {"stats": {"hd": {"amp2": rng.standard_normal(3),
                            "snr": rng.standard_normal(3), "sigma": 0.5}}}
    lnl = {"lnl": rng.standard_normal((3, 4))}
    kw = dict(os=os_, lnlike=lnl, queued_s=0.0012, service_s=0.01,
              latency_s=0.0113, cohort_requests=2, bucket=8,
              pad_waste_frac=0.25)
    got = cli.response_json(7, ServeResult(**arrays, **kw), emit)
    want = jcli.response_json(7, JaxResult(**arrays, **kw), emit)
    assert got == want
    assert cli.response_json(1, {"a": 1}) == jcli.response_json(1, {"a": 1})


def test_error_json_equals_jax():
    pairs = ((ServeBusy("full", retry_after_s=0.123456),
              JaxBusy("full", retry_after_s=0.123456)),
             (ServeTimeout("late"), JaxTimeout("late")),
             (RuntimeError("boom"), RuntimeError("boom")))
    for got, want in pairs:
        assert cli.error_json(3, got) == jcli.error_json(3, want)


def _session(pool, lines):
    out = io.StringIO()
    n = cli._serve_stream(pool, [json.dumps(d) if isinstance(d, dict)
                                 else d for d in lines],
                          out.write, SPEC, "full")
    replies = [json.loads(x) for x in out.getvalue().splitlines()]
    return n, {r["id"]: r for r in replies}


def test_stdin_session(pool):
    """A JSON-lines session: served kinds answer their results (the sim
    reply equals the same request through the pool), the inline kinds
    their payloads, a malformed line ``bad_request``, the stream kinds
    (an append opening the stream, its stats, a cutover onto a wider
    template) and a ``sample`` session their payloads, and a stream that
    is not open an error."""
    lines = [
        {"id": 1, "kind": "sim", "n": 3, "seed": 5},
        {"id": 2, "kind": "os", "n": 2, "seed": 6, "null": True},
        {"id": 3, "kind": "ping"},
        {"id": 4, "kind": "stats"},
        {"id": 5, "kind": "telemetry"},
        {"id": 6, "kind": "metrics"},
        "{not json",
        {"id": 8, "kind": "append", "stream": "s0",
         "toas": [[1e6, 2e6]] * 4, "residuals": [[1e-7, -1e-7]] * 4,
         "spec": SPEC_KW},
        {"id": 9, "kind": "stream", "stream": "s0"},
        {"id": 11, "kind": "cutover", "stream": "s0",
         "spec": dict(SPEC_KW, tspan_years=20.0)},
        {"id": 12, "kind": "sim", "n": 3, "seed": 5, "trace_id": "abc"},
        {"id": 13, "kind": "stream", "stream": "nope"},
    ]
    # the sampling session first, alone: its chains would share the CPU
    # with the served requests' dispatches
    n_sample, rep = _session(pool, [{"id": 10, "kind": "sample",
                                     "steps": 2}])
    assert n_sample == 0
    n, served = _session(pool, lines)
    rep.update(served)
    # the sim, os and traced sim futures, and the append's and the
    # stream's (resolved at submit)
    assert n == 5
    want = pool.serve(SimRequest(spec=SPEC, n=3, seed=5), timeout=300)
    assert np.array_equal(np.asarray(rep[1]["curves"]), want.curves)
    assert rep[12]["trace_id"] == "abc"
    assert set(rep[2]["os"]["hd"]) >= {"amp2", "null_amp2", "p_value"}
    assert rep[3] == {"id": 3, "ok": True, "pong": True}
    assert {"stats", "health", "pool", "streams"} <= set(rep[4])
    assert rep[4]["health"]["state"] == "healthy"
    assert rep[5]["telemetry"]["slo"]["serve_requests"] >= 0
    assert "# TYPE fakepta_up gauge" in rep[6]["metrics"]
    assert rep[None]["code"] == "bad_request"
    assert rep[8]["ok"] and rep[8]["stream"]["n_toas"] == 8
    assert rep[9]["ok"] and rep[9]["stream"]["appends"] == 1
    assert rep[10]["ok"] and rep[10]["done"]
    assert rep[10]["n_kept"] > 0 and "rhat_max" in rep[10]["summary"]
    assert rep[11]["ok"] and rep[11]["cutover"]["toas"] == 8
    assert rep[11]["cutover"]["new_tspan_s"] > \
        rep[11]["cutover"]["old_tspan_s"]
    assert rep[13]["ok"] is False and rep[13]["code"] == "error"
    assert "not open" in rep[13]["error"]


def _args(**kw):
    base = dict(npsr=4, ntoa=32, tspan_years=15.0, n_red=3, n_dm=3,
                gwb_orf="hd", gwb_ncomp=3, host="127.0.0.1", port=0,
                emit="summary")
    base.update(kw)
    return argparse.Namespace(**base)


def _ask(rfile, conn, obj):
    conn.sendall((json.dumps(obj) + "\n").encode())
    return json.loads(rfile.readline())


def test_socket_server_and_obs_top_alerts(pool, capsys):
    server = cli._socket_server(pool, _args(), idle_timeout_s=30.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=60) as c:
            rfile = c.makefile("rb")
            assert _ask(rfile, c, {"id": 1, "kind": "ping"})["pong"]
            sim = _ask(rfile, c, {"id": 2, "n": 4, "seed": 3})
            want = pool.serve(SimRequest(spec=SPEC, n=4, seed=3),
                              timeout=300)
            np.testing.assert_array_equal(sim["curve_mean"],
                                          want.curves.mean(axis=0))
            assert _ask(rfile, c, {"id": 3, "kind": "stats"})["stats"][
                "serve_requests"] >= 1
            snap = _ask(rfile, c, {"id": 4, "kind": "telemetry"})
            assert snap["telemetry"]["health"]["state"] == "healthy"
            met = _ask(rfile, c, {"id": 5, "kind": "metrics"})["metrics"]
            assert 'fakepta_up{replica="self"} 1' in met
        capsys.readouterr()
        assert obs_cli.main(["top", f"127.0.0.1:{port}",
                             "--iterations", "1"]) == 0
        frame = capsys.readouterr().out
        assert frame.startswith("fleet: 1 replicas")
        assert "127.0.0.1" in frame          # the replica column, cut to 10
        assert obs_cli.main(["alerts", f"127.0.0.1:{port}"]) == 0
        assert capsys.readouterr().out.strip() == "no alerts"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)


def test_replica_subprocess_prints_its_ready_banner(tmp_path):
    """``replica --port 0``: one JSON banner line with the bound port, a
    live socket behind it, a report at shutdown."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.Popen(
        [sys.executable, "-m", "fakepta_tpu_torch.serve", "replica",
         "--port", "0", "--device", "cpu", "--npsr", "4", "--ntoa", "32",
         "--n-red", "3", "--n-dm", "3", "--gwb-ncomp", "3",
         "--buckets", "8", "--index", "3"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        banner = json.loads(proc.stdout.readline())
        assert banner["event"] == "ready" and banner["index"] == 3
        assert banner["n_devices"] == 1
        with socket.create_connection(("127.0.0.1", banner["port"]),
                                      timeout=60) as c:
            rfile = c.makefile("rb")
            assert _ask(rfile, c, {"id": 1, "kind": "ping"})["pong"]
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        proc.stdout.close()
        proc.stderr.close()


def test_commands_of_the_fleet_slice_exit_2(capsys):
    """The fleet commands run: without a card (and without ``--device
    cpu``) ``fleet`` and ``loadgen --fleet`` exit 2 naming
    ``device='cpu'`` (their replicas cannot reach a card, and none falls
    back to the CPU); ``replica --register`` to a router that is not
    listening exits 2 naming the failed join."""
    if not torch.cuda.is_available():
        assert cli.main(["fleet", "--replicas", "2", "--transport",
                         "inproc"]) == 2
        assert cli.main(["loadgen", "--fleet", "2", "--npsr", "4",
                         "--ntoa", "32"]) == 2
        assert capsys.readouterr().err.count("device='cpu'") >= 2
    assert cli.main(["replica", "--device", "cpu", "--npsr", "4", "--ntoa",
                     "32", "--register", "127.0.0.1:1"]) == 2
    assert "register with 127.0.0.1:1 failed" in capsys.readouterr().err


def test_cli_loadgen_on_the_cpu_and_default_to_the_card(capsys):
    """``loadgen`` serves on the card by default: without one it exits 2
    naming ``device='cpu'``; with ``--device cpu`` it prints one row."""
    if not torch.cuda.is_available():
        assert cli.main(["loadgen", "--npsr", "4", "--ntoa", "32"]) == 2
        assert "device='cpu'" in capsys.readouterr().err
    assert cli.main(["loadgen", "--device", "cpu", "--npsr", "4",
                     "--ntoa", "32", "--n-red", "3", "--n-dm", "3",
                     "--gwb-ncomp", "3", "--requests", "6", "--sizes",
                     "1", "2", "--buckets", "4", "--verify", "1"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["serve_requests"] == 6 and row["serve_verified"] == 1
