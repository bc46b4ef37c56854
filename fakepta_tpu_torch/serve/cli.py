"""CLI: ``python -m fakepta_tpu_torch.serve loadgen|stdin|socket|replica``
(port of ``fakepta_tpu.serve.cli``).

Four commands over the serving layer, on the card unless ``--device cpu``
is given (the JAX CLI's ``--devices`` / ``--jax-platform`` / ``--x64``
have no counterpart: the pool serves on one device):

- ``loadgen``: the built-in synthetic load generator / benchmark
  (:mod:`.loadgen`): prints ONE JSON row with the SLO metrics (and, with
  ``--baseline``, the serial-dispatch comparison and ``serve_speedup_x``);
- ``stdin``: JSON-lines request/response over stdin/stdout: each input
  line is a request object, each output line a response (responses
  stream in completion order; match them by ``id``);
- ``socket``: the same JSON-lines protocol over TCP (one connection per
  client, threaded);
- ``replica``: the socket server plus a one-line JSON ready banner on
  stdout (``{"event": "ready", "port": ..., "n_devices": ..., "index":
  ...}``, how a client learns the bound port with ``--port 0``) and
  ``--index`` stamping the report's ``process_index``.

``fleet``, ``replica --register`` and ``loadgen --fleet`` need the fleet
(ROADMAP Queue 1 item 11b slice 4): they print that and exit 2.

Request line schema (shared by stdin / socket / replica)::

    {"id": 1, "kind": "sim"|"os"|"infer", "n": 16, "seed": 7,
     "spec": {"npsr": 20, ...} | "registered-name",   # optional: default spec
     "deadline_ms": 250,                               # optional
     "orf": "hd", "weighting": "noise", "null": false, # kind == "os"
     "grid": {"k": 4, "nbin": 10},                     # kind == "infer"
     "lnlike": {"schema": "fakepta_tpu.infer-spec/1", ...}}  # infer, exact

plus the inline kinds ``ping`` (``{"id", "ok": true, "pong": true}``, the
health plane's probe), ``stats`` (the pool's SLO summary with ``health``,
``pool`` and ``streams``), ``telemetry`` (one publisher snapshot) and
``metrics`` (Prometheus text exposition in the ``metrics`` field). The
kinds ``append``, ``stream``, ``sample`` and ``cutover`` parse, and
answer ``{"id", "ok": false, "code": "error", "error": ...}`` naming the
ROADMAP slice that brings them.

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

#: what the protocol kinds and commands that need a later slice answer
NOT_PORTED = {
    "sample": "the 'sample' kind needs fleet.build_session_run, which the "
              "port does not have yet (ROADMAP Queue 1 item 11b slice 4)",
    "cutover": "the 'cutover' kind needs the gateway's StreamManager "
               "cutover, which the port does not have yet (ROADMAP Queue 1 "
               "item 11b slice 5)",
    "fleet": "the fleet needs serve/fleet.py, which the port does not have "
             "yet (ROADMAP Queue 1 item 11b slice 4)",
}


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


def _serve_stream(pool, lines, write, default_spec, emit: str) -> int:
    """Drive the pool from an iterator of request lines; responses stream
    through ``write`` in completion order. Returns the served count."""
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
                emit_line({"id": req_id, "ok": True,
                           "stats": pool.slo_summary(),
                           "health": pool.health_summary(),
                           "pool": pool.warm_summary(),
                           "streams": pool.stream_summary()})
                continue
            if kind == "telemetry":
                emit_line({"id": req_id, "ok": True,
                           "telemetry": pool.telemetry_snapshot()})
                continue
            if kind == "metrics":
                emit_line({"id": req_id, "ok": True,
                           "metrics": pool.metrics_text()})
                continue
            if kind in ("sample", "cutover"):
                emit_line(error_json(req_id,
                                     NotImplementedError(NOT_PORTED[kind])))
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
            out = (error_json(req_id, exc) if exc is not None
                   else response_json(req_id, f.result(), emit))
            if trace_id:
                out["trace_id"] = trace_id
            emit_line(out)

        fut.add_done_callback(_done)
        futs.append(fut)
    for f in futs:
        try:
            f.result(timeout=600.0)
        # every failure was already emitted as an error line by the
        # future's done callback above
        except Exception:   # noqa: BLE001
            pass
    return len(futs)


def _make_pool(args) -> ServePool:
    return ServePool(config=_config_from_args(args), device=args.device)


def _cmd_loadgen(args) -> int:
    from .loadgen import run_loadgen

    if args.fleet is not None:
        print(f"error: {NOT_PORTED['fleet']}", file=sys.stderr)
        return 2
    row = run_loadgen(
        spec=_spec_from_args(args), n_requests=args.requests,
        sizes=tuple(args.sizes), kind=args.kind, rate_hz=args.rate,
        seed=args.seed, baseline=args.baseline, verify=args.verify,
        config=_config_from_args(args), report_path=args.report,
        device=args.device)
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

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            try:
                _serve_stream(pool,
                              _bounded_lines(self.rfile, self.connection,
                                             idle_timeout_s),
                              lambda s: (self.wfile.write(s.encode()),
                                         self.wfile.flush()),
                              default_spec, emit)
            except OSError as exc:
                # client went away mid-response: connection-scoped
                flightrec.note("serve_socket_write_error",
                               error=repr(exc)[:160])

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    return Server((args.host, args.port), Handler)


def _cmd_socket(args, banner: bool = False) -> int:
    if getattr(args, "register", None):
        print(f"error: replica --register: {NOT_PORTED['fleet']}",
              file=sys.stderr)
        return 2
    pool = _make_pool(args)
    with _socket_server(pool, args, args.idle_timeout) as server:
        if banner:
            # a client spawning the replica with --port 0 learns the bound
            # port from this one-line JSON banner
            print(json.dumps({"event": "ready",
                              "port": server.server_address[1],
                              "n_devices": pool.n_devices,
                              "index": getattr(args, "index", 0)}),
                  flush=True)
        else:
            print(f"serving on {args.host}:{server.server_address[1]} "
                  f"(JSON-lines; ^C to stop)", file=sys.stderr)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
    if args.report:
        rep = pool.report()
        rep.meta["process_index"] = int(getattr(args, "index", 0))
        rep.save(args.report)
    pool.close()
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
    lg.add_argument("--fleet", type=int, default=None,
                    help=argparse.SUPPRESS)

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
    rp.add_argument("--register", default=None, metavar="HOST:PORT",
                    help="join a fleet router (not ported yet: exits 2)")
    rp.add_argument("--replica-id", default=None,
                    help="fleet identity to join as (with --register)")

    sub.add_parser("fleet", help="multi-replica load benchmark (not "
                                 "ported yet: exits 2 whatever its flags)")
    return parser


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["fleet"]:
        print(f"error: {NOT_PORTED['fleet']}", file=sys.stderr)
        return 2
    args = build_parser().parse_args(argv)
    try:
        if args.command == "loadgen":
            return _cmd_loadgen(args)
        if args.command == "stdin":
            return _cmd_stdin(args)
        if args.command == "replica":
            return _cmd_socket(args, banner=True)
        return _cmd_socket(args)
    except RuntimeError as exc:
        if "device='cpu'" not in str(exc):
            raise
        # no card and the CPU not asked for: a usage error
        print(f"error: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":                               # pragma: no cover
    sys.exit(main())
