"""CLI: ``python -m fakepta_tpu_torch.serve
loadgen|stdin|socket|replica|fleet`` (port of ``fakepta_tpu.serve.cli``).

Five commands over the serving layer, on the card unless ``--device cpu``
is given (the JAX CLI's ``--devices`` / ``--jax-platform`` / ``--x64`` /
``--compile-cache`` have no counterpart: a pool serves on one device, the
port has no global float mode, and replicas share the kernel build
directory):

- ``loadgen``: the built-in synthetic load generator / benchmark
  (:mod:`.loadgen`): prints ONE JSON row with the SLO metrics (and, with
  ``--baseline``, the serial-dispatch comparison and ``serve_speedup_x``);
  ``--fleet N`` serves the row through N socket replicas instead
  (``run_loadgen(fleet=N)``);
- ``stdin``: JSON-lines request/response over stdin/stdout: each input
  line is a request object, each output line a response (responses
  stream in completion order; match them by ``id``);
- ``socket``: the same JSON-lines protocol over TCP (one connection per
  client, threaded);
- ``replica``: the fleet endpoint: the socket server plus a one-line JSON
  ready banner on stdout (``{"event": "ready", "port": ..., "n_devices":
  ..., "devices": [...], "index": ...}``, how the router learns the bound
  port with ``--port 0``), ``--index`` stamping the report's
  ``process_index``, ``--threads`` setting its torch thread count (the
  router passes its own, so CPU float sums agree bit for bit) and
  ``--register HOST:PORT`` joining a running router's ring through the
  hello / adopt handshake (``ServeFleet.listen``). A replica whose
  dispatch meets a sticky CUDA error or a kernel build failure exits
  (code 70) without answering, so its router fails the request over to
  a sibling;
- ``fleet``: the multi-replica load benchmark (``run_loadgen(fleet=N)``,
  :mod:`.fleet`): N replica subprocesses (or in-process pools) behind the
  consistent-hash router, one fleet row (``fleet_qps_per_chip``,
  ``fleet_p50_ms`` / ``p99``, failovers, warm-pool hit rate); replica i
  serves on ``--devices``' i-th entry (else ``--device``).

Request line schema (shared by stdin / socket / replica)::

    {"id": 1, "kind": "sim"|"os"|"infer", "n": 16, "seed": 7,
     "spec": {"npsr": 20, ...} | "registered-name",   # optional: default spec
     "deadline_ms": 250,                               # optional
     "orf": "hd", "weighting": "noise", "null": false, # kind == "os"
     "grid": {"k": 4, "nbin": 10},                     # kind == "infer"
     "lnlike": {"schema": "fakepta_tpu.infer-spec/1", ...}}  # infer, exact

Streaming ingestion kinds (replica-affine: a fleet routes them by stream
name, never spilling to a sibling)::

    {"id": 2, "kind": "append", "stream": "ng20", "toas": [[...]],
     "residuals": [[...]],                             # (P, B) seconds
     "sigma2": [[...]], "freqs": [[...]],              # optional
     "ecorr_amp": [[...]], "counts": [...],            # optional
     "spec": {...}, "ecorr_dt": 2592000.0,             # open-time options
     "watch": "hd", "checkpoint": "/shared/stream"}    # (first touch only)
    {"id": 3, "kind": "stream", "stream": "ng20"}      # rolling stats
    {"id": 4, "kind": "cutover", "stream": "ng20", "spec": {...},
     "checkpoint": "/shared/stream2"}                  # frozen-grid migration

``append`` and ``stream`` answer ``{"id", "ok": true, "stream": {...}}``,
``cutover`` ``{"id", "ok": true, "cutover": {...}}`` once the swap landed
(an aborted cutover answers an error and leaves the old state installed).

Plus the inline kinds ``ping`` (``{"id", "ok": true, "pong": true}``,
the health plane's probe), ``stats`` (the pool's SLO summary with
``health``, ``pool``, ``streams`` and ``kernels``: this process's kernel
launches, by bucket too, and its nvcc starts), ``telemetry`` (one
publisher snapshot) and ``metrics`` (Prometheus text exposition in the
``metrics`` field); and ``{"id", "kind": "sample", "steps": 64, "seed":
7, "spec": {...}, "session": {"n_chains": 4, ...}, "checkpoint":
"/shared/ck"}``, a posterior-as-a-service session that STREAMS one line
per drained segment (``{"id", "ok": true, "seg": k, ...thinned
draws...}``) and a final ``{"id", "ok": true, "done": true, "summary":
{...}}``; with ``checkpoint`` on a shared filesystem a sibling replica
resumes the session bit-exactly after a failover.

Responses: ``{"id", "ok": true, "n", "latency_ms", "queued_ms", "bucket",
"cohort_requests", ...results}`` with ``--emit summary`` (per-request
curve means) or ``--emit full`` (full per-realization arrays). Failures:
``{"id", "ok": false, "code": "busy"|"timeout"|"error", "error": msg}``;
``busy`` carries the scheduler's ``retry_after_s`` hint; a malformed line
answers ``bad_request`` and the session survives.

Socket hardening: a per-connection idle ``settimeout``
(``--idle-timeout``), a bounded request-line length
(:data:`MAX_REQUEST_LINE`) and flight-recorder notes on malformed frames.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading

import numpy as np

from ..obs import flightrec
from .scheduler import ServeConfig, ServePool
from .spec import (AppendRequest, ArraySpec, InferRequest, OSRequest,
                   ServeBusy, ServeTimeout, SimRequest, StreamRequest,
                   curn_grid_spec)

#: longest request line a server will read before declaring the frame
#: malformed and closing the connection
MAX_REQUEST_LINE = 1 * 1024 * 1024

#: default per-connection idle timeout
DEFAULT_IDLE_TIMEOUT_S = 300.0

#: the exit code of a replica whose process can no longer serve (a
#: sticky CUDA error or a kernel build failure): its router sees the
#: connection close and fails the request over
POISONED_EXIT = 70


def _spec_from_args(args) -> ArraySpec:
    return ArraySpec(npsr=args.npsr, ntoa=args.ntoa,
                     tspan_years=args.tspan_years, n_red=args.n_red,
                     n_dm=args.n_dm, gwb_orf=args.gwb_orf,
                     gwb_ncomp=args.gwb_ncomp)


def _config_from_args(args) -> ServeConfig:
    kw = {}
    if args.buckets:
        kw["buckets"] = tuple(args.buckets)
    if args.max_queue_depth is not None:
        kw["max_queue_depth"] = args.max_queue_depth
    if args.window_ms is not None:
        kw["coalesce_window_s"] = args.window_ms / 1e3
    if args.prewarm_buckets:
        kw["prewarm_buckets"] = tuple(args.prewarm_buckets)
    return ServeConfig(**kw)


def request_from_json(d: dict, default_spec: ArraySpec):
    """One request line -> request object (see module docstring schema)."""
    kind = d.get("kind", "sim")
    spec = d.get("spec")
    if kind in ("append", "stream"):
        # stream-affine kinds: no n / seed, spec only as an open-time
        # template (never defaulted)
        stream_spec = ArraySpec(**spec) if isinstance(spec, dict) else None
        deadline = d.get("deadline_ms")
        deadline_s = (float(deadline) / 1e3 if deadline is not None
                      else None)
        trace_id = d.get("trace_id")
        if kind == "stream":
            return StreamRequest(stream=str(d["stream"]),
                                 deadline_s=deadline_s,
                                 trace_id=trace_id)
        arr = lambda k: (np.asarray(d[k], dtype=np.float64)  # noqa: E731
                         if d.get(k) is not None else None)
        return AppendRequest(
            stream=str(d["stream"]), toas=arr("toas"),
            residuals=arr("residuals"), spec=stream_spec,
            sigma2=arr("sigma2"), freqs=arr("freqs"),
            ecorr_amp=arr("ecorr_amp"), counts=arr("counts"),
            ecorr_dt=(float(d["ecorr_dt"])
                      if d.get("ecorr_dt") is not None else None),
            watch=d.get("watch"), checkpoint=d.get("checkpoint"),
            deadline_s=deadline_s, trace_id=trace_id)
    if spec is None:
        spec = default_spec
    elif isinstance(spec, dict):
        spec = ArraySpec(**spec)
    elif not isinstance(spec, str):
        raise ValueError("spec must be an object or a registered name")
    n = int(d["n"])
    seed = int(d.get("seed", 0))
    deadline = d.get("deadline_ms")
    deadline_s = float(deadline) / 1e3 if deadline is not None else None
    trace_id = d.get("trace_id")
    if kind == "sim":
        return SimRequest(spec=spec, n=n, seed=seed, deadline_s=deadline_s,
                          trace_id=trace_id)
    if kind == "os":
        return OSRequest(spec=spec, n=n, seed=seed, deadline_s=deadline_s,
                         orf=d.get("orf", "hd"),
                         weighting=d.get("weighting", "noise"),
                         null=bool(d.get("null", False)),
                         trace_id=trace_id)
    if kind == "infer":
        if d.get("lnlike") is not None:
            # the exact form: a full infer.schema InferSpec document
            from ..infer import spec_from_json
            lnlike = spec_from_json(d["lnlike"])
        else:
            grid = d.get("grid") or {}
            lnlike = curn_grid_spec(
                k=int(grid.get("k", 4)),
                log10_A=tuple(grid.get("log10_A", (-15.2, -14.2))),
                gamma=tuple(grid.get("gamma", (3.0, 6.0))),
                nbin=int(grid.get("nbin", 10)))
        return InferRequest(spec=spec, n=n, seed=seed, deadline_s=deadline_s,
                            lnlike=lnlike, trace_id=trace_id)
    raise ValueError(f"unknown request kind {kind!r}")


def response_json(req_id, res, emit: str = "summary") -> dict:
    if isinstance(res, dict):
        # stream-affine kinds resolve to plain payload dicts
        return {"id": req_id, "ok": True, "stream": res}
    out = {
        "id": req_id, "ok": True, "n": int(res.curves.shape[0]),
        "latency_ms": round(res.latency_s * 1e3, 3),
        "queued_ms": round(res.queued_s * 1e3, 3),
        "bucket": res.bucket, "cohort_requests": res.cohort_requests,
    }
    if emit == "full":
        out["curves"] = np.asarray(res.curves).tolist()
        out["autos"] = np.asarray(res.autos).tolist()
        out["bin_centers"] = np.asarray(res.bin_centers).tolist()
        if res.os is not None:
            out["os"] = {orf: {k: (np.asarray(v).tolist()
                                   if isinstance(v, np.ndarray) else v)
                               for k, v in entry.items()}
                         for orf, entry in res.os["stats"].items()}
        if res.lnlike is not None:
            out["lnl"] = np.asarray(res.lnlike["lnl"]).tolist()
    else:
        out["curve_mean"] = np.asarray(res.curves).mean(axis=0).tolist()
        out["autos_mean"] = float(np.asarray(res.autos).mean())
        if res.os is not None:
            out["os"] = {orf: {"amp2_mean": float(np.mean(e["amp2"])),
                               "snr_mean": float(np.mean(e["snr"]))}
                         for orf, e in res.os["stats"].items()}
        if res.lnlike is not None:
            out["lnl_max"] = float(np.max(res.lnlike["lnl"]))
    return out


def request_to_json(req, req_id) -> dict:
    """Request object -> protocol line (the client half of
    :func:`request_from_json`). ``InferRequest`` serializes its InferSpec
    through :mod:`..infer.schema`."""
    if getattr(req, "stream_affine", False):
        d = {"id": req_id, "kind": req.kind, "stream": str(req.stream)}
        if req.deadline_s is not None:
            d["deadline_ms"] = req.deadline_s * 1e3
        if getattr(req, "trace_id", None):
            d["trace_id"] = req.trace_id
        if req.kind == "append":
            for key in ("toas", "residuals", "sigma2", "freqs",
                        "ecorr_amp", "counts"):
                val = getattr(req, key)
                if val is not None:
                    d[key] = np.asarray(val).tolist()
            if req.spec is not None:
                if not isinstance(req.spec, ArraySpec):
                    raise ValueError("only ArraySpec stream templates "
                                     "cross the socket protocol")
                d["spec"] = dataclasses.asdict(req.spec)
            if req.ecorr_dt is not None:
                d["ecorr_dt"] = float(req.ecorr_dt)
            if req.watch is not None:
                d["watch"] = str(req.watch)
            if req.checkpoint is not None:
                d["checkpoint"] = str(req.checkpoint)
        return d
    d = {"id": req_id, "kind": req.kind, "n": int(req.n),
         "seed": int(req.seed)}
    if req.deadline_s is not None:
        d["deadline_ms"] = req.deadline_s * 1e3
    if getattr(req, "trace_id", None):
        d["trace_id"] = req.trace_id
    if isinstance(req.spec, str):
        d["spec"] = req.spec
    elif isinstance(req.spec, ArraySpec):
        d["spec"] = dataclasses.asdict(req.spec)
    else:
        raise ValueError("only named or ArraySpec requests cross the "
                         "socket protocol")
    if isinstance(req, InferRequest):
        from ..infer import spec_to_json
        d["lnlike"] = spec_to_json(req.lnlike)
    if isinstance(req, OSRequest):
        d["orf"] = (req.orf if isinstance(req.orf, str) else list(req.orf))
        d["weighting"] = req.weighting
        d["null"] = bool(req.null)
    return d


def error_json(req_id, exc) -> dict:
    code = ("busy" if isinstance(exc, ServeBusy)
            else "timeout" if isinstance(exc, ServeTimeout) else "error")
    out = {"id": req_id, "ok": False, "code": code, "error": str(exc)}
    hint = getattr(exc, "retry_after_s", None)
    if hint is not None:
        out["retry_after_s"] = round(float(hint), 4)
    return out


def _serve_sample(pool, d: dict, req_id, emit_line, default_spec,
                  emit: str) -> None:
    """One posterior-as-a-service session (protocol kind ``sample``):
    streams a line per drained segment, then the summary line. Runs
    synchronously on the connection's handler thread: one connection is
    one session."""
    from .fleet import SampleSessionSpec, build_session_run

    spec = d.get("spec")
    spec = ArraySpec(**spec) if isinstance(spec, dict) else default_spec
    knob_names = ("nbin", "n_chains", "n_temps", "warmup", "thin",
                  "step_size", "n_leapfrog", "data_seed", "bin_offset",
                  "data_nbin")
    knobs = {k: v for k, v in (d.get("session") or {}).items()
             if k in knob_names}
    sess = SampleSessionSpec(spec=spec, n_steps=int(d.get("steps", 32)),
                             seed=int(d.get("seed", 0)),
                             segment=d.get("segment"), **knobs)
    run = build_session_run(sess, pool.mesh)

    def on_segment(idx, arr):
        msg = {"id": req_id, "ok": True, "seg": int(idx),
               "n": int(arr.shape[0])}
        if emit == "full":
            msg["theta"] = np.asarray(arr).tolist()
        else:
            msg["theta_mean"] = np.asarray(arr).mean(axis=(0, 1)).tolist()
        emit_line(msg)

    out = run.run(sess.n_steps, seed=sess.seed, segment=sess.segment,
                  checkpoint=d.get("checkpoint"), pipeline_depth=0,
                  on_segment=on_segment)
    emit_line({"id": req_id, "ok": True, "done": True,
               "summary": out["summary"],
               "n_kept": int(out["theta"].shape[0]),
               "param_names": list(out["param_names"])})


def _die_poisoned(exc) -> None:
    """Exit the process without answering: its CUDA context (or its
    kernels) can serve nothing more, and the closed connection is what
    makes the router fail the request over."""
    flightrec.note("replica_poisoned_exit", error=repr(exc)[:300])
    print(f"replica exiting: {exc!r}", file=sys.stderr, flush=True)
    os._exit(POISONED_EXIT)


def _serve_stream(pool, lines, write, default_spec, emit: str,
                  exit_on_poison: bool = False) -> int:
    """Drive the pool from an iterator of request lines; responses stream
    through ``write`` in completion order. Returns the served count.
    ``exit_on_poison`` (replicas): a failure that poisons the process
    (:func:`..faults.recovery.poisons_process`) exits it instead of
    answering."""
    from ..faults.recovery import poisons_process

    wlock = threading.Lock()
    futs = []

    def emit_line(obj):
        with wlock:
            write(json.dumps(obj) + "\n")

    for raw in lines:
        raw = raw.strip()
        if not raw:
            continue
        d = None
        try:
            d = json.loads(raw)
            req_id = d.get("id")
            kind = d.get("kind", "sim")
            if kind == "ping":
                # heartbeat probe: answered inline, nothing dispatched
                emit_line({"id": req_id, "ok": True, "pong": True})
                continue
            if kind == "stats":
                out = {"id": req_id, "ok": True,
                       "stats": pool.slo_summary(),
                       "health": pool.health_summary(),
                       "pool": pool.warm_summary(),
                       "streams": pool.stream_summary(),
                       "kernels": pool.kernel_summary()}
                # a gateway front (..gateway) adds its tenant table:
                # per-tenant qps / 429s / queue share / hit-rate rows
                tenants = getattr(pool, "tenant_summary", None)
                if tenants is not None:
                    out["tenants"] = tenants()
                emit_line(out)
                continue
            if kind == "telemetry":
                emit_line({"id": req_id, "ok": True,
                           "telemetry": pool.telemetry_snapshot()})
                continue
            if kind == "metrics":
                emit_line({"id": req_id, "ok": True,
                           "metrics": pool.metrics_text()})
                continue
            if kind == "sample":
                try:
                    _serve_sample(pool, d, req_id, emit_line, default_spec,
                                  emit)
                except Exception as exc:   # noqa: BLE001 — answered
                    if exit_on_poison and poisons_process(exc):
                        _die_poisoned(exc)
                    else:
                        emit_line(error_json(req_id, exc))
                continue
            if kind == "cutover":
                # frozen-grid migration: synchronous by design, the reply
                # IS the fence release, so the caller knows the swap landed
                spec = d.get("spec")
                if not isinstance(spec, dict):
                    raise ValueError("cutover needs a spec object (the "
                                     "wider template)")
                try:
                    info = pool.cutover_stream(
                        str(d["stream"]), ArraySpec(**spec),
                        checkpoint=d.get("checkpoint"))
                except Exception as exc:   # noqa: BLE001 — an abort is an
                    # error line; the old state stays installed
                    emit_line(error_json(req_id, exc))
                else:
                    emit_line({"id": req_id, "ok": True, "cutover": info})
                continue
            req = request_from_json(d, default_spec)
        except (ValueError, KeyError, TypeError, AttributeError) as exc:
            flightrec.note("serve_bad_request", error=repr(exc)[:200])
            emit_line({"id": d.get("id") if isinstance(d, dict) else None,
                       "ok": False, "code": "bad_request",
                       "error": str(exc)})
            continue
        try:
            fut = pool.submit(req)
        except Exception as exc:   # Busy/Closed/ValueError -> error line
            emit_line(error_json(req_id, exc))
            continue

        def _done(f, req_id=req_id,
                  trace_id=getattr(req, "trace_id", None)):
            exc = f.exception()
            if exc is not None and exit_on_poison and poisons_process(exc):
                _die_poisoned(exc)
                return
            out = (error_json(req_id, exc) if exc is not None
                   else response_json(req_id, f.result(), emit))
            if trace_id:
                out["trace_id"] = trace_id
            emit_line(out)

        fut.add_done_callback(_done)
        futs.append(fut)
    for f in futs:
        # a failed request was emitted as an error line by its done
        # callback above: exception() returns the failure instead of
        # raising it, and raises only if the request is still unanswered
        f.exception(timeout=600.0)
    return len(futs)


def _make_pool(args) -> ServePool:
    return ServePool(config=_config_from_args(args), device=args.device)


def _cmd_loadgen(args) -> int:
    from .loadgen import run_loadgen

    row = run_loadgen(
        spec=_spec_from_args(args), n_requests=args.requests,
        sizes=tuple(args.sizes), kind=args.kind, rate_hz=args.rate,
        seed=args.seed, baseline=args.baseline, verify=args.verify,
        config=_config_from_args(args), report_path=args.report,
        fleet=args.fleet, device=args.device)
    print(json.dumps(row))
    return 0


def _cmd_stdin(args) -> int:
    pool = _make_pool(args)
    try:
        n = _serve_stream(pool, sys.stdin, sys.stdout.write,
                          _spec_from_args(args), args.emit)
        sys.stdout.flush()
    finally:
        if args.report:
            pool.save_report(args.report)
        pool.close()
    print(f"served {n} request(s)", file=sys.stderr)
    return 0


def _bounded_lines(rfile, connection, idle_timeout_s: float):
    """Request lines from a socket file, hardened: a per-connection idle
    ``settimeout`` bounds every blocking read, the line length is bounded
    by :data:`MAX_REQUEST_LINE`, and both failure modes leave a
    flight-recorder note instead of a pinned handler thread."""
    import socket as socket_mod

    if idle_timeout_s:
        connection.settimeout(idle_timeout_s)
    while True:
        try:
            raw = rfile.readline(MAX_REQUEST_LINE + 1)
        except socket_mod.timeout:
            flightrec.note("serve_socket_idle_timeout")
            return
        except OSError as exc:
            flightrec.note("serve_socket_read_error",
                           error=repr(exc)[:160])
            return
        if not raw:
            return
        if len(raw) > MAX_REQUEST_LINE:
            flightrec.note("serve_socket_oversized_frame", bytes=len(raw))
            return
        yield raw.decode("utf-8", "replace")


def _socket_server(pool, args, idle_timeout_s: float):
    """The hardened threaded JSON-lines TCP server (``socket`` and
    ``replica``)."""
    import socketserver

    default_spec = _spec_from_args(args)
    emit = args.emit

    exit_on_poison = getattr(args, "command", None) == "replica"

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            try:
                _serve_stream(pool,
                              _bounded_lines(self.rfile, self.connection,
                                             idle_timeout_s),
                              lambda s: (self.wfile.write(s.encode()),
                                         self.wfile.flush()),
                              default_spec, emit,
                              exit_on_poison=exit_on_poison)
            except OSError as exc:
                # client went away mid-response: connection-scoped
                flightrec.note("serve_socket_write_error",
                               error=repr(exc)[:160])

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    return Server((args.host, args.port), Handler)


def _register_with_router(register: str, replica_id: str,
                          serving_port: int, n_devices: int, index: int,
                          timeout_s: float = 30.0) -> None:
    """The replica side of the join handshake: dial the router's admin
    port, send one JSON ``hello`` line advertising our serving port,
    await the ``adopt`` reply. Bounded at every step: a dead router is a
    start-up failure."""
    import socket as socket_mod

    host, _, port_s = register.rpartition(":")
    conn = socket_mod.create_connection((host or "127.0.0.1", int(port_s)),
                                        timeout=timeout_s)
    try:
        conn.settimeout(timeout_s)
        conn.sendall((json.dumps(
            {"event": "hello", "port": int(serving_port),
             "replica_id": replica_id, "index": int(index),
             "n_devices": int(n_devices)}) + "\n").encode())
        line = conn.makefile("rb").readline(MAX_REQUEST_LINE + 1)
        reply = json.loads(line.decode("utf-8", "replace")) if line else {}
        if reply.get("event") != "adopt":
            raise RuntimeError(f"router rejected the join: {reply!r}")
        flightrec.note("replica_adopted", router=register,
                       replicas=int(reply.get("replicas", 0)))
    finally:
        conn.close()


def _cmd_socket(args, banner: bool = False) -> int:
    threads = getattr(args, "threads", None)
    if threads:
        import torch
        torch.set_num_threads(int(threads))
    pool = _make_pool(args)
    with _socket_server(pool, args, args.idle_timeout) as server:
        if banner:
            # a client spawning the replica with --port 0 learns the bound
            # port (and the devices it serves on) from this one-line banner
            devices = sorted({str(d) for d in pool.mesh.devices.flat})
            print(json.dumps({"event": "ready",
                              "port": server.server_address[1],
                              "n_devices": pool.n_devices,
                              "devices": devices,
                              "index": getattr(args, "index", 0)}),
                  flush=True)
        else:
            print(f"serving on {args.host}:{server.server_address[1]} "
                  f"(JSON-lines; ^C to stop)", file=sys.stderr)
        register = getattr(args, "register", None)
        register_failed = []
        if register:
            # the handshake runs while the server is accepting: the
            # router's _adopt prewarms the joiner over its serving port
            # BEFORE it replies `adopt`, so registering from the main
            # thread ahead of serve_forever() would deadlock (the router
            # waits on a prewarm the replica cannot serve, the replica on
            # an adopt the router cannot send). A failure shuts the
            # server down.
            rid = (getattr(args, "replica_id", None)
                   or f"replica-{server.server_address[1]}")

            def _register():
                try:
                    _register_with_router(register, rid,
                                          server.server_address[1],
                                          pool.n_devices,
                                          getattr(args, "index", 0))
                except (OSError, RuntimeError, ValueError) as exc:
                    flightrec.note("replica_register_failed",
                                   error=repr(exc)[:200])
                    print(f"register with {register} failed: {exc!r}",
                          file=sys.stderr)
                    register_failed.append(exc)
                    server.shutdown()

            threading.Thread(target=_register, name="replica-register",
                             daemon=True).start()
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        if register_failed:
            pool.close()
            return 2
    if args.report:
        rep = pool.report()
        rep.meta["process_index"] = int(getattr(args, "index", 0))
        rep.save(args.report)
    pool.close()
    return 0


def _cmd_fleet(args) -> int:
    from .loadgen import run_fleet_loadgen

    row = run_fleet_loadgen(
        spec=_spec_from_args(args), fleet=args.replicas,
        transport=args.transport, n_requests=args.requests,
        sizes=tuple(args.sizes), kind=args.kind, seed=args.seed,
        baseline=args.baseline, verify=args.verify, n_specs=args.specs,
        kill_one_at=args.kill_one_at, config=_config_from_args(args),
        report_path=args.report, device=args.device,
        devices=args.devices or None)
    print(json.dumps(row))
    return 0


def _add_common(p):
    p.add_argument("--npsr", type=int, default=20)
    p.add_argument("--ntoa", type=int, default=156)
    p.add_argument("--tspan-years", type=float, default=15.0)
    p.add_argument("--n-red", type=int, default=10)
    p.add_argument("--n-dm", type=int, default=10)
    p.add_argument("--gwb-orf", default="hd",
                   help="common-signal ORF ('' disables the GWB)")
    p.add_argument("--gwb-ncomp", type=int, default=10)
    p.add_argument("--buckets", type=int, nargs="*", default=None,
                   help="microbatch bucket ladder (default: "
                        "16..1024, ratio 2)")
    p.add_argument("--prewarm-buckets", type=int, nargs="*", default=None)
    p.add_argument("--max-queue-depth", type=int, default=None)
    p.add_argument("--window-ms", type=float, default=None,
                   help="coalesce window in milliseconds (default 2)")
    p.add_argument("--device", default="cuda",
                   help="torch device the pool serves on (default cuda; "
                        "cpu runs the kernels' plain versions)")
    p.add_argument("--report", default=None,
                   help="write the pool's obs RunReport artifact here")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m fakepta_tpu_torch.serve",
        description="warm-pool serving layer with a microbatch coalescing "
                    "scheduler")
    sub = parser.add_subparsers(dest="command", required=True)

    lg = sub.add_parser("loadgen", help="synthetic load benchmark: one "
                                        "JSON row of SLO metrics")
    _add_common(lg)
    lg.add_argument("--requests", type=int, default=64)
    lg.add_argument("--sizes", type=int, nargs="*", default=[4, 8, 16, 32])
    lg.add_argument("--kind", choices=("sim", "os", "infer"), default="sim")
    lg.add_argument("--rate", type=float, default=None,
                    help="submission rate in Hz (default: flat-out)")
    lg.add_argument("--seed", type=int, default=0)
    lg.add_argument("--baseline", action="store_true",
                    help="also measure serial per-request run() dispatch "
                         "and report serve_speedup_x")
    lg.add_argument("--verify", type=int, default=3,
                    help="check this many served responses against the "
                         "same request alone and its solo run (0 disables)")
    lg.add_argument("--fleet", type=int, default=None, metavar="N",
                    help="serve the row through N socket replicas behind "
                         "the fleet router (the fleet command's row)")

    st = sub.add_parser("stdin", help="JSON-lines request/response over "
                                      "stdin/stdout")
    _add_common(st)
    st.add_argument("--emit", choices=("summary", "full"), default="summary")

    def _add_socket_common(p):
        p.add_argument("--host", default="127.0.0.1")
        p.add_argument("--port", type=int, default=8791,
                       help="TCP port (0 = bind any free port)")
        p.add_argument("--emit", choices=("summary", "full"),
                       default="summary")
        p.add_argument("--idle-timeout", type=float,
                       default=DEFAULT_IDLE_TIMEOUT_S,
                       help="per-connection idle timeout in seconds "
                            "(0 disables; default 300)")

    so = sub.add_parser("socket", help="JSON-lines over TCP")
    _add_common(so)
    _add_socket_common(so)

    rp = sub.add_parser("replica", help="the socket server + a JSON ready "
                                        "banner")
    _add_common(rp)
    _add_socket_common(rp)
    rp.set_defaults(emit="full")     # bit-verification needs the full
    #                                  per-realization arrays
    rp.add_argument("--index", type=int, default=0,
                    help="replica index (the report's process_index)")
    rp.add_argument("--threads", type=int, default=None,
                    help="torch thread count (the router passes its own: "
                         "CPU float sums depend on it)")
    rp.add_argument("--register", default=None, metavar="HOST:PORT",
                    help="dial a running router's admin port "
                         "(ServeFleet.listen) and join its ring through "
                         "the hello / adopt handshake")
    rp.add_argument("--replica-id", default=None,
                    help="fleet identity to join as (default: "
                         "replica-<port>)")

    fl = sub.add_parser("fleet", help="multi-replica load benchmark: one "
                                      "JSON row of fleet SLO metrics")
    _add_common(fl)
    fl.add_argument("--replicas", type=int, default=3)
    fl.add_argument("--transport", choices=("process", "inproc"),
                    default="process",
                    help="replica transport: subprocess sockets or "
                         "in-process pools")
    fl.add_argument("--devices", nargs="*", default=None,
                    help="replica i serves on the i-th device (cycled; "
                         "e.g. cuda:0 cuda:1 for a card a replica; "
                         "default: every replica on --device)")
    fl.add_argument("--requests", type=int, default=96)
    fl.add_argument("--sizes", type=int, nargs="*", default=[1, 2, 4])
    fl.add_argument("--specs", type=int, default=6,
                    help="distinct specs in the traffic (the spec-space "
                         "working set the ring shards)")
    fl.add_argument("--kind", choices=("sim", "os"), default="sim")
    fl.add_argument("--seed", type=int, default=0)
    fl.add_argument("--baseline", action="store_true",
                    help="also serve the same traffic through ONE pool "
                         "and report fleet_speedup_x")
    fl.add_argument("--verify", type=int, default=3)
    fl.add_argument("--kill-one-at", type=float, default=None,
                    help="kill one replica after this fraction of "
                         "requests is submitted (the failover A/B; "
                         "responses stay bit-verified)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.command == "loadgen":
            return _cmd_loadgen(args)
        if args.command == "stdin":
            return _cmd_stdin(args)
        if args.command == "replica":
            return _cmd_socket(args, banner=True)
        if args.command == "fleet":
            return _cmd_fleet(args)
        return _cmd_socket(args)
    except RuntimeError as exc:
        if "device='cpu'" not in str(exc):
            raise
        # no card and the CPU not asked for: a usage error
        print(f"error: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":                               # pragma: no cover
    sys.exit(main())
