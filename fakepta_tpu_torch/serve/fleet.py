"""Horizontal scale-out: a spec-hash-routed fleet of ServePool replicas
(port of ``fakepta_tpu.serve.fleet``).

One :class:`~.scheduler.ServePool` is one dispatcher in one process:
aggregate throughput is capped at one card's coalescing win and warm
capacity at one LRU pool (``max_specs`` resident specs). The fleet puts a
router in front of N replicas:

- **spec-hash routing** (:mod:`.router`): requests consistent-hash by
  ``spec_hash`` so each replica's warm pool stays hot on its shard of the
  spec space; aggregate warm capacity scales N times, and with a card a
  replica the N dispatchers run in parallel;
- **spillover**: a saturated owner (its fleet in-flight bound, or a
  ``ServeBusy`` from its own admission control) spills to the ring's next
  replica, deterministic per spec;
- **fleet-wide backpressure**: when every live replica is saturated the
  router raises its own :class:`~.spec.ServeBusy` whose ``retry_after_s``
  is the smallest of the replicas' backlog hints;
- **failover**: a dead or wedged replica (connection loss, closed pool,
  an injected ``fleet.replica`` kill) triggers mid-flight re-dispatch of
  its in-flight requests to the next live sibling. The per-request RNG
  lane makes the failed-over response bit-identical to the same request
  served alone at the same bucket. A failed-over request is not held to
  the router's in-flight bound again (it was admitted once; only the
  sibling's own admission control applies). No response is ever computed
  on the CPU in a card replica's place: failover is routing between
  replicas;
- **posterior-as-a-service** (:class:`SamplingSession`): long-running
  sampling runs with replica affinity, segment-boundary checkpoints as
  the migration unit on failover, per-segment streamed draws.

Two replica transports share one interface: :class:`LocalReplica` wraps an
in-process pool, :class:`SocketReplica` spawns ``python -m
fakepta_tpu_torch.serve replica`` and speaks the JSON-lines socket
protocol (``serve/cli.py``). The fleet itself is transport-agnostic.

Kept divergences from the JAX fleet:

- **device defaults**: replicas serve on ``"cuda"`` unless ``device=`` (or
  ``mesh=``) says otherwise; the JAX ``SocketReplica`` spawns on the CPU
  (``jax_platform="cpu"``). A replica that cannot reach its card fails to
  start and raises; the fleet never adds a CPU replica on its own;
- **no compile cache**: the JAX fleet shares XLA's persistent compile
  cache so that a sibling's cold start is a cache load. The port's
  counterpart is the kernel build directory (:mod:`..ops._build`,
  ``FAKEPTA_TORCH_BUILD_DIR``, builds renamed into place atomically),
  which spawned replicas inherit: a replica that starts after the kernels
  are built starts no nvcc. ``compile_cache_dir`` is accepted where the
  JAX signature has it and must be ``None``;
- **failover past the bound**: the JAX router holds a failed-over
  request to the sibling's in-flight bound and fails it with
  ``ServeBusy`` when the sibling is at it, losing a request it had
  accepted (two socket replicas sharing an NVIDIA H100 lost 48 of 128
  flat-out requests at a kill that way); the port re-dispatches it past
  the bound;
- **no ``--x64``**: the port has no global float mode (a request's dtype
  is its spec's), so a spawned replica takes none; it takes the router's
  torch thread count (``--threads``) instead, since CPU float sums differ
  across thread counts and a failed-over response must equal the router's
  solo run bit for bit.

Observability: :meth:`ServeFleet.slo_summary` rolls the router's counters
(``fleet_qps_per_chip``, ``fleet_p50_ms`` / ``fleet_p99_ms``,
``fleet_failovers``, ``fleet_warm_hit_rate``, ...) up under the JAX
fleet's names; per-replica RunReports carry a ``process_index`` so ``obs
trace`` merges them into one timeline with a pid lane per replica.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import Future
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import faults as faults_mod
from ..device import DeviceLike
from ..obs import flightrec, metrics
from ..obs.timing import now
from .router import HashRing
from .scheduler import ServeConfig, ServePool, ServeResult
from .spec import (ArraySpec, ServeBusy, ServeClosed, ServeError,
                   ServeTimeout, SimRequest, no_compile_cache,
                   resolve_spec_hash)

#: longest protocol line a replica client reads before declaring the
#: frame malformed
MAX_LINE_BYTES = 8 * 1024 * 1024


class ReplicaDead(ServeError):
    """The target replica is gone (process death, connection loss, closed
    pool): the router fails over instead of retrying in place."""


def _device_keys(mesh) -> Tuple[str, ...]:
    """The distinct devices of a mesh as strings (``"cuda:0"``, ``"cpu"``):
    replicas naming the same key share a chip."""
    return tuple(sorted({str(d) for d in mesh.devices.flat}))


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Router-tier knobs (per-replica scheduler knobs stay in
    :class:`~.scheduler.ServeConfig`).

    ``max_inflight_per_replica`` is the router's own admission bound (the
    router bounds what it hands a replica, the replica bounds what it
    accepts from everyone). ``max_failovers`` caps per-request
    re-dispatches so a poisoned request cannot tour the fleet forever.
    """

    max_inflight_per_replica: int = 64
    max_failovers: int = 2
    vnodes: int = 64
    result_window: int = 4096        # fleet SLO ring capacity (requests)


class _Inflight:
    __slots__ = ("req", "spec_hash", "outer", "t_enq", "failovers",
                 "replica_id", "owner_id")

    def __init__(self, req, spec_hash, outer, t_enq, owner_id):
        self.req = req
        self.spec_hash = spec_hash
        self.outer = outer
        self.t_enq = t_enq
        self.failovers = 0
        self.replica_id = None
        self.owner_id = owner_id


# ---------------------------------------------------------------------------
# replica transports
# ---------------------------------------------------------------------------

class LocalReplica:
    """An in-process replica: one :class:`ServePool` behind the fleet
    interface (embedding, and the transport of the CPU fleet tests: no
    subprocess start-up, the same routing and failover).

    The pool serves on ``mesh``, else on ``device`` (default ``"cuda"``,
    raising without a GPU)."""

    def __init__(self, replica_id: str, mesh=None,
                 config: Optional[ServeConfig] = None,
                 compile_cache_dir: Optional[str] = None, index: int = 0,
                 device: DeviceLike = None):
        no_compile_cache(compile_cache_dir)
        self.id = str(replica_id)
        self.index = int(index)
        self.pool = ServePool(mesh=mesh, config=config, device=device)
        self.alive = True

    @property
    def n_devices(self) -> int:
        return self.pool.n_devices

    def device_ids(self) -> Tuple[str, ...]:
        return _device_keys(self.pool.mesh)

    def submit(self, req) -> Future:
        if not self.alive:
            raise ReplicaDead(f"replica {self.id} is dead")
        try:
            return self.pool.submit(req)
        except ServeClosed as exc:
            self.alive = False
            raise ReplicaDead(f"replica {self.id} pool is closed") from exc

    def retry_hint(self) -> float:
        with self.pool._lock:
            return self.pool._retry_after_locked()

    def slo_summary(self) -> dict:
        return self.pool.slo_summary()

    def kernel_summary(self) -> dict:
        return self.pool.kernel_summary()

    def report(self):
        rep = self.pool.report()
        rep.meta["process_index"] = self.index
        rep.meta["replica_id"] = self.id
        return rep

    def sampling_run(self, sess: "SampleSessionSpec"):
        """The session's :class:`..sample.SamplingRun` on THIS replica's
        mesh (the affinity contract: the staged moments and warm start
        live with the replica that owns the session)."""
        return build_session_run(sess, self.pool.mesh)

    def ping(self, deadline_s: float = 1.0) -> bool:
        """Health probe (serve/health.py): alive means the pool's
        dispatcher thread is running, not just the flag."""
        if not self.alive or not self.pool._dispatcher.is_alive():
            raise ReplicaDead(f"replica {self.id} dispatcher is gone")
        return True

    def telemetry(self, deadline_s: float = 1.0) -> dict:
        """Telemetry scrape: one publisher snapshot, read in process."""
        if not self.alive:
            raise ReplicaDead(f"replica {self.id} is dead")
        return self.pool.telemetry_snapshot()

    def kill(self) -> None:
        """Simulated replica death: pending work fails like a crashed
        process (the in-process analog of SIGKILL)."""
        self.alive = False
        self.pool.close(drain=False)

    def close(self) -> None:
        self.alive = False
        self.pool.close()


class SocketReplica:
    """A subprocess replica speaking the JSON-lines socket protocol.

    Spawns ``python -m fakepta_tpu_torch.serve replica --port 0`` on
    ``device`` (default ``"cuda"``; replica i of a card-a-replica fleet
    takes ``"cuda:i"``), reads its one-line JSON ready banner for the
    bound port, and multiplexes requests over one connection: a writer
    lock serializes request lines, one reader thread resolves futures by
    ``id``. Reader EOF or a socket error marks the replica dead and fails
    every in-flight future with :class:`ReplicaDead`, which triggers the
    router's mid-flight failover. ``threads`` (default: this process's
    torch thread count) is the child's torch thread count. The child's
    standard error goes to a temporary file, quoted when it fails to
    start and removed on :meth:`close`.

    Attach mode (``connect=(host, port)``): the replica process already
    exists (it dialed the router's admin port with a ``hello``), so there
    is nothing to spawn; :meth:`kill` severs the connection.
    """

    def __init__(self, replica_id: str,
                 spec_defaults: Optional[ArraySpec] = None,
                 compile_cache_dir: Optional[str] = None,
                 buckets: Optional[Sequence[int]] = None, index: int = 0,
                 device: str = "cuda", threads: Optional[int] = None,
                 startup_timeout_s: float = 180.0,
                 io_timeout_s: float = 600.0, report_path=None,
                 connect: Optional[Tuple[str, int]] = None,
                 n_devices: int = 1):
        no_compile_cache(compile_cache_dir)
        self.id = str(replica_id)
        self.index = int(index)
        self.alive = False
        self._lock = threading.Lock()
        self._pending: dict = {}          # req id -> Future
        self._raw: set = set()            # ids answered with the raw line
        self._next_id = 0
        self._devices: Tuple[str, ...] = ()
        self._stderr = None
        if connect is not None:
            self.proc = None
            host, self.port = str(connect[0]), int(connect[1])
            self.n_devices = int(n_devices)
        else:
            if spec_defaults is None:
                raise ValueError("spawn mode needs spec_defaults "
                                 "(attach mode passes connect=)")
            import torch

            cmd = [sys.executable, "-m", "fakepta_tpu_torch.serve",
                   "replica", "--port", "0", "--emit", "full",
                   "--index", str(self.index),
                   "--npsr", str(spec_defaults.npsr),
                   "--ntoa", str(spec_defaults.ntoa),
                   "--device", str(device),
                   "--threads", str(int(threads or
                                        torch.get_num_threads()))]
            if buckets:
                cmd += ["--buckets"] + [str(b) for b in buckets]
            if report_path is not None:
                cmd += ["--report", str(report_path)]
            # the package root leads the child's import path whatever the
            # caller's working directory (python -m resolves from cwd)
            pkg_root = str(Path(__file__).resolve().parents[2])
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                [pkg_root] + [p for p in env.get("PYTHONPATH", "").split(
                    os.pathsep) if p])
            self._stderr = tempfile.NamedTemporaryFile(
                prefix=f"fakepta-replica-{self.id}-", suffix=".log",
                delete=False)
            self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=self._stderr, text=True,
                                         cwd=pkg_root, env=env)
            banner = self._read_banner(startup_timeout_s)
            self.port = int(banner["port"])
            self.n_devices = int(banner.get("n_devices", 1))
            self._devices = tuple(banner.get("devices", ()))
            host = "127.0.0.1"
        try:
            self.sock = socket.create_connection((host, self.port),
                                                 timeout=io_timeout_s)
        except OSError:
            if self.proc is not None:     # a spawned child is ours to stop
                self.proc.kill()
                self.proc.wait(timeout=30)
                self._drop_stderr()
            raise
        # the connect timeout persists as the I/O deadline: a wedged (not
        # just dead) replica surfaces as a timed-out read -> ReplicaDead
        # -> failover, never a pinned reader thread
        self.sock.settimeout(io_timeout_s)
        self._rfile = self.sock.makefile("rb")
        self.alive = True
        self._reader = threading.Thread(target=self._read_loop,
                                        name=f"fleet-reader-{self.id}",
                                        daemon=True)
        self._reader.start()

    def _stderr_tail(self, nbytes: int = 4000) -> str:
        if self._stderr is None:
            return ""
        try:
            self._stderr.flush()
            with open(self._stderr.name, "rb") as fh:
                fh.seek(0, os.SEEK_END)
                fh.seek(max(fh.tell() - nbytes, 0))
                return fh.read().decode("utf-8", "replace")
        except OSError:
            return ""

    def _read_banner(self, timeout_s: float) -> dict:
        """The replica's ready line; a subprocess that dies before binding
        surfaces as a startup error quoting its standard error, never a
        hang."""
        done = {}

        def wait_line():
            done["line"] = self.proc.stdout.readline()

        t = threading.Thread(target=wait_line, daemon=True)
        t.start()
        t.join(timeout_s)
        line = done.get("line")
        if not line:
            self.proc.kill()
            self.proc.wait(timeout=30)
            tail = self._stderr_tail()
            self._drop_stderr()
            raise ReplicaDead(
                f"replica {self.id} printed no ready banner within "
                f"{timeout_s}s (exit {self.proc.returncode}); its stderr "
                f"ends:\n{tail}")
        banner = json.loads(line)
        if banner.get("event") != "ready":
            self.proc.kill()
            raise ReplicaDead(f"replica {self.id} bad banner: {banner!r}")
        return banner

    def _drop_stderr(self) -> None:
        # close() may come from the caller and from the fleet's admin
        # thread at once: the lock hands the file to exactly one of them
        with self._lock:
            log = self._stderr
            self._stderr = None
        if log is not None:
            log.close()
            try:
                os.unlink(log.name)
            except OSError:
                pass

    def device_ids(self) -> Tuple[str, ...]:
        return self._devices

    def _send(self, obj_fn, raw: bool = False) -> Future:
        """Register a future under a fresh id and send ``obj_fn(id)`` as
        one line; a send failure kills the replica and raises."""
        if not self.alive:
            raise ReplicaDead(f"replica {self.id} is dead")
        fut: Future = Future()
        send_exc: Optional[OSError] = None
        with self._lock:
            req_id = self._next_id
            self._next_id += 1
            self._pending[req_id] = fut
            if raw:
                self._raw.add(req_id)
            line = json.dumps(obj_fn(req_id)) + "\n"
            try:
                self.sock.sendall(line.encode())
            except OSError as exc:
                self._pending.pop(req_id, None)
                self._raw.discard(req_id)
                send_exc = exc
        if send_exc is not None:
            self._die(repr(send_exc))
            raise ReplicaDead(
                f"replica {self.id} send failed: {send_exc!r}") from send_exc
        fut.req_id = req_id
        return fut

    def submit(self, req) -> Future:
        from .cli import request_to_json

        return self._send(lambda i: request_to_json(req, i))

    def _read_loop(self):
        try:
            for raw in iter(lambda: self._rfile.readline(MAX_LINE_BYTES + 1),
                            b""):
                if len(raw) > MAX_LINE_BYTES:
                    raise ReplicaDead(
                        f"replica {self.id} sent an oversized frame")
                self._on_line(json.loads(raw.decode("utf-8", "replace")))
        except (OSError, ValueError, ReplicaDead) as exc:
            self._die(repr(exc))
            return
        self._die("connection closed (EOF)")

    def _on_line(self, d: dict):
        with self._lock:
            fut = self._pending.pop(d.get("id"), None)
            raw = d.get("id") in self._raw
            self._raw.discard(d.get("id"))
        if fut is None:
            return
        if d.get("ok"):
            fut.set_result(d if raw else _result_from_json(d))
            return
        code = d.get("code")
        if code == "busy":
            fut.set_exception(ServeBusy(
                d.get("error", "replica busy"),
                retry_after_s=float(d.get("retry_after_s", 0.0))))
        else:
            exc_cls = ServeTimeout if code == "timeout" else ServeError
            fut.set_exception(exc_cls(d.get("error", f"replica error "
                                                     f"({code})")))

    def _die(self, why: str):
        """Mark the replica dead and fail its in-flight futures.

        Two phases: state flips under ``self._lock``, futures resolve
        OUTSIDE it. ``set_exception`` runs completion callbacks
        synchronously; the fleet's failover callback re-submits to a
        sibling replica and takes the fleet lock plus the sibling's lock,
        so resolving under our own lock would be a cross-instance ABBA
        deadlock (two replicas dying while dispatch fails over in the
        other direction)."""
        with self._lock:
            if not self.alive and not self._pending:
                return
            self.alive = False
            pending, self._pending = self._pending, {}
            self._raw = set()
        flightrec.note("fleet_replica_lost", replica=self.id, why=why[:200])
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(ReplicaDead(
                    f"replica {self.id} died mid-flight: {why}"))

    def _inline(self, kind: str, timeout: float) -> dict:
        """One inline protocol kind (``ping`` / ``stats`` / ``telemetry``)
        over the mux'd connection; the raw reply line. A deadline expiry
        raises; the late reply, if it lands, resolves a future nobody
        holds."""
        fut = self._send(lambda i: {"id": i, "kind": kind}, raw=True)
        try:
            return fut.result(timeout=timeout)
        except concurrent.futures.TimeoutError:
            with self._lock:
                self._pending.pop(fut.req_id, None)
                self._raw.discard(fut.req_id)
            raise

    def stats(self, timeout: float = 60.0) -> dict:
        """The replica's live ServePool SLO summary (protocol kind
        ``stats``)."""
        got = self._inline("stats", timeout).get("stats")
        return got if isinstance(got, dict) else {}

    def kernel_summary(self, timeout: float = 60.0) -> dict:
        """The replica process's kernel launches and nvcc starts (the
        ``stats`` reply's ``kernels``)."""
        got = self._inline("stats", timeout).get("kernels")
        return got if isinstance(got, dict) else {}

    def retry_hint(self) -> float:
        return 0.0

    def ping(self, deadline_s: float = 1.0) -> bool:
        """Health probe over the mux'd connection (protocol kind
        ``ping``, answered inline by the replica's connection thread: a
        miss means the process or its socket plumbing is stuck, not
        merely busy)."""
        self._inline("ping", deadline_s)
        return True

    def telemetry(self, deadline_s: float = 1.0) -> dict:
        """Telemetry scrape over the SAME mux'd connection as requests and
        pings (protocol kind ``telemetry``): zero new connections."""
        got = self._inline("telemetry", deadline_s).get("telemetry")
        return got if isinstance(got, dict) else {}

    def kill(self) -> None:
        """SIGKILL the replica process (in-flight requests fail over
        through the reader thread's EOF); an adopted replica has no
        process handle, and severing the connection is the same lever."""
        if self.proc is not None:
            self.proc.kill()
        else:
            try:
                self.sock.close()
            except OSError:
                pass

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        if self.proc is not None and self.proc.stdout is not None:
            self.proc.stdout.close()
        self._drop_stderr()
        # _die, not a bare attribute write: `alive` is read by dispatch
        # and health threads, and straggler futures must fail, not hang
        self._die("replica closed")


def _result_from_json(d: dict):
    """A full-emit response line -> :class:`ServeResult` (the socket
    transport reconstitutes what the in-process pool returns; a ``stats``
    or stream payload passes through as a dict)."""
    if "pong" in d and "curves" not in d:
        return {"pong": True}
    if "stats" in d and "curves" not in d:
        return d["stats"]
    if "telemetry" in d and "curves" not in d:
        return d["telemetry"]
    if "metrics" in d and "curves" not in d:
        return d["metrics"]
    if "stream" in d and "curves" not in d:
        return d["stream"]
    res = ServeResult(
        curves=np.asarray(d["curves"]),
        autos=np.asarray(d["autos"]),
        bin_centers=np.asarray(d.get("bin_centers", [])),
        cohort_requests=int(d.get("cohort_requests", 1)),
        bucket=int(d.get("bucket", 0)))
    res.latency_s = float(d.get("latency_ms", 0.0)) / 1e3
    res.queued_s = float(d.get("queued_ms", 0.0)) / 1e3
    if d.get("os") is not None:
        res.os = d["os"]
    if d.get("lnl") is not None:
        res.lnlike = {"lnl": np.asarray(d["lnl"])}
    return res


# ---------------------------------------------------------------------------
# the router tier
# ---------------------------------------------------------------------------

class _FleetStats:
    def __init__(self, window: int):
        self.latency_ms = collections.deque(maxlen=window)
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.rejected = 0
        self.cancelled = 0
        self.failovers = 0
        self.spillovers = 0
        self.deaths = 0
        self.joins = 0
        self.drains = 0
        self.owner_served = 0
        self.per_replica = collections.Counter()
        self.t_first = None
        self.t_last = None


class ServeFleet:
    """N replicas behind the consistent-hash router (module docstring).

    >>> fleet = ServeFleet([LocalReplica("r0"), LocalReplica("r1")])
    >>> res = fleet.serve(SimRequest(spec=ArraySpec(npsr=8), n=4, seed=7))
    >>> res.replica, res.failovers
    """

    def __init__(self, replicas: Sequence,
                 config: Optional[FleetConfig] = None):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.config = config or FleetConfig()
        self.replicas = {r.id: r for r in replicas}
        if len(self.replicas) != len(replicas):
            raise ValueError("replica ids must be unique")
        self.ring = HashRing([r.id for r in replicas],
                             vnodes=self.config.vnodes)
        self._lock = threading.Lock()
        self._inflight = collections.Counter()      # replica id -> count
        self._stats = _FleetStats(self.config.result_window)
        self._closed = False
        # trace propagation: the router mints a trace_id per request
        # (unless the client line carried one) and keeps a router-lane
        # timeline of route spans and failover markers
        self._t0 = now()
        self._trace_seq = 0
        self._trace_nonce = flightrec.spec_hash(
            {"kind": "fleet-trace", "nonce": id(self)})[:6]
        self._timeline = collections.deque(
            maxlen=self.config.result_window)
        # fleet-level telemetry rollups, fed by the heartbeat scrape once
        # enable_health() runs
        from ..obs import telemetry as telemetry_mod
        self.telemetry = telemetry_mod.TelemetryAggregator()
        # the served working set (spec -> buckets it ran at), LRU-bounded:
        # what join() prewarms onto a new replica's absorbed shard
        self._recent: "collections.OrderedDict" = collections.OrderedDict()
        self._recent_cap = 64
        self.health = None                 # HealthMonitor, enable_health()
        self._admin_sock = None            # the join-handshake listener
        self._admin_thread = None
        flightrec.note("fleet_start", replicas=len(replicas))

    # -- chip accounting ---------------------------------------------------
    @property
    def n_chips(self) -> int:
        """Distinct chips under the fleet: replicas naming the same device
        share it (two replicas on ``cuda:0`` are one chip); a replica that
        names none (an adopted one) counts its own."""
        local_ids: set = set()
        remote = 0
        for r in self.replicas.values():
            ids = r.device_ids()
            if ids:
                local_ids.update(ids)
            else:
                remote += int(r.n_devices)
        return max(len(local_ids) + remote, 1)

    def alive_replicas(self) -> List[str]:
        return [rid for rid, r in self.replicas.items() if r.alive]

    # -- admission / routing -------------------------------------------------
    def submit(self, req) -> Future:
        """Route one request; returns a Future resolving to a
        :class:`ServeResult` whose ``replica`` / ``failovers`` fields record
        where it ran. Raises :class:`ServeBusy` (with the aggregated
        ``retry_after_s``) when every live replica is saturated,
        :class:`ServeClosed` after shutdown, :class:`ServeError` when no
        replica is alive."""
        with self._lock:
            if self._closed:
                raise ServeClosed("fleet is closed")
        if getattr(req, "stream_affine", False):
            # stream affinity: the routing identity is the STREAM NAME, so
            # every request for one stream prefers the same ring owner,
            # where the accumulated moments live
            spec_hash = flightrec.spec_hash(
                {"kind": "stream", "name": req.affinity_key()})
        elif not isinstance(req.spec, str):
            spec_hash = resolve_spec_hash(req.spec, {})
        else:
            spec_hash = flightrec.spec_hash(
                {"kind": "registered", "name": req.spec})
        if getattr(req, "trace_id", None) is None:
            with self._lock:
                self._trace_seq += 1
                seq = self._trace_seq
            try:
                req = dataclasses.replace(
                    req, trace_id=f"t{self._trace_nonce}-{seq:06d}")
            except TypeError:
                pass          # a non-dataclass request stays untraced
        outer: Future = Future()
        t = now()
        # ring reads under the fleet lock: membership mutates live
        # (join / retire), and HashRing is not internally synchronized
        with self._lock:
            owner = self.ring.owner(spec_hash)
        inf = _Inflight(req, spec_hash, outer, t, owner_id=owner)
        with self._lock:
            self._stats.submitted += 1
            if self._stats.t_first is None:
                self._stats.t_first = t
        self._dispatch(inf, exclude=())
        return outer

    def serve(self, req, timeout: Optional[float] = None):
        return self.submit(req).result(timeout=timeout)

    def _mark_dead(self, rid: str, why: str) -> None:
        r = self.replicas.get(rid)
        newly = r is not None and r.alive
        if r is not None:
            r.alive = False
        with self._lock:
            if newly:
                self._stats.deaths += 1
        if newly:
            flightrec.note("fleet_replica_dead", replica=rid,
                           why=str(why)[:200])

    def _dispatch(self, inf: _Inflight, exclude: Tuple[str, ...]) -> None:
        """Try the spec's preference order once; busy replicas spill to
        the next, dead ones are skipped. Runs on the submitter's thread
        first and on a replica's completion thread after a failover."""
        hints: List[float] = []
        spilled = False
        # stream-affine requests NEVER spill on saturation: the stream's
        # moments live on exactly one replica (dead owners ARE skipped:
        # failover re-opens the stream, continuous via a shared checkpoint)
        affine = bool(getattr(inf.req, "stream_affine", False))
        hm = self.health
        with self._lock:
            pref = list(self.ring.preference(inf.spec_hash))
        for rid in pref:
            if rid in exclude:
                continue
            replica = self.replicas.get(rid)
            if replica is None or not replica.alive:
                continue
            if hm is not None and not hm.routable(rid):
                # breaker open (suspect / wedged): drained before any
                # request could time out into it
                continue
            with self._lock:
                # the in-flight bound is admission control for NEW
                # requests: a failed-over one was admitted already, and
                # a busy sibling must not turn it into a lost request
                saturated = (not inf.failovers and self._inflight[rid]
                             >= self.config.max_inflight_per_replica)
                if not saturated:
                    self._inflight[rid] += 1
            if saturated:
                # the hint read takes the replica pool's own lock: NEVER
                # under the fleet lock (a dying pool's dispatcher holds
                # its lock while our completion callback takes the fleet
                # lock)
                hints.append(replica.retry_hint())
                if affine:
                    break
                spilled = True
                continue
            # fault site: the router's dispatch to a replica. `kill` takes
            # the replica down mid-flight; failover finishes elsewhere
            try:
                faults_mod.check("fleet.replica", replica=rid)
            except faults_mod.TransientFault:
                with self._lock:
                    self._inflight[rid] -= 1
                spilled = True
                continue
            except faults_mod.KillFault:
                with self._lock:
                    self._inflight[rid] -= 1
                self._mark_dead(rid, "injected fleet.replica kill")
                replica.kill()
                continue
            try:
                inner = replica.submit(inf.req)
            except ServeBusy as busy:
                with self._lock:
                    self._inflight[rid] -= 1
                hints.append(getattr(busy, "retry_after_s", 0.0))
                if affine:
                    break              # no spillover for stream affinity
                with self._lock:
                    self._stats.spillovers += 1
                spilled = True
                continue
            except (ReplicaDead, ConnectionError, OSError) as exc:
                with self._lock:
                    self._inflight[rid] -= 1
                self._mark_dead(rid, repr(exc))
                continue
            except BaseException:
                # validation errors propagate to the submitter, but must
                # not leak the in-flight slot
                with self._lock:
                    self._inflight[rid] -= 1
                raise
            if spilled:
                with self._lock:
                    self._stats.spillovers += 1
                flightrec.note("fleet_spillover", spec=inf.spec_hash, to=rid)
            inf.replica_id = rid
            inner.add_done_callback(
                lambda f, inf=inf, rid=rid: self._on_done(inf, rid, f))
            return
        # nobody took it
        if not self.alive_replicas():
            with self._lock:
                self._stats.failed += 1
            err = ServeError("no live replica in the fleet")
        else:
            hint = min(hints) if hints else 0.0
            with self._lock:
                self._stats.rejected += 1
            flightrec.note("fleet_busy", spec=inf.spec_hash,
                           retry_after_s=round(hint, 4))
            err = ServeBusy(
                f"every live replica is saturated; retry in ~{hint:.3f}s",
                retry_after_s=hint)
        # the first dispatch (from submit) raises; a failover resolves the
        # future instead
        if inf.failovers == 0 and not inf.outer.done():
            raise err
        if not inf.outer.done():
            inf.outer.set_exception(err)

    def _on_done(self, inf: _Inflight, rid: str, inner: Future) -> None:
        with self._lock:
            self._inflight[rid] -= 1
        exc = inner.exception()
        if exc is None:
            res = inner.result()
            if isinstance(res, dict):  # stream payloads are plain dicts
                res = dict(res, replica=rid, failovers=inf.failovers)
            else:
                res.replica = rid
                res.failovers = inf.failovers
                # the served working set: (spec, bucket) pairs a joining
                # replica prewarms for its absorbed shard
                spec = getattr(inf.req, "spec", None)
                if spec is not None and not isinstance(spec, str):
                    with self._lock:
                        _spec, buckets = self._recent.setdefault(
                            inf.spec_hash, (spec, set()))
                        buckets.add(int(res.bucket))
                        self._recent.move_to_end(inf.spec_hash)
                        while len(self._recent) > self._recent_cap:
                            self._recent.popitem(last=False)
            t_done = now()
            with self._lock:
                st = self._stats
                st.completed += 1
                st.t_last = t_done
                st.latency_ms.append((t_done - inf.t_enq) * 1e3)
                st.per_replica[rid] += 1
                if rid == inf.owner_id:
                    st.owner_served += 1
                ev = {"name": "route", "tid": "router",
                      "t0": inf.t_enq - self._t0,
                      "dur": t_done - inf.t_enq, "replica": rid,
                      "failovers": inf.failovers,
                      "req_kind": getattr(inf.req, "kind", "?")}
                if getattr(inf.req, "trace_id", None):
                    ev["trace_id"] = inf.req.trace_id
                self._timeline.append(ev)
            inf.outer.set_result(res)
            return
        verdict = faults_mod.classify_replica(exc)
        if (verdict == "replica_death"
                and inf.failovers < self.config.max_failovers):
            self._mark_dead(rid, repr(exc))
            inf.failovers += 1
            with self._lock:
                self._stats.failovers += 1
                ev = {"name": "fleet_failover", "tid": "router",
                      "t0": now() - self._t0,
                      "from_replica": rid, "attempt": inf.failovers}
                if getattr(inf.req, "trace_id", None):
                    ev["trace_id"] = inf.req.trace_id
                self._timeline.append(ev)
            flightrec.note("fleet_failover", spec=inf.spec_hash,
                           from_replica=rid, attempt=inf.failovers)
            # re-dispatch to the ring's next live sibling: the RNG lane
            # makes the rerun bit-identical at the same bucket
            try:
                self._dispatch(inf, exclude=(rid,))
            except ServeBusy as busy:
                if not inf.outer.done():
                    inf.outer.set_exception(busy)
            return
        if isinstance(exc, ServeBusy) and not getattr(
                inf.req, "stream_affine", False) and inf.failovers \
                < self.config.max_failovers:
            # an asynchronous 429 from a socket replica: spill, not fail
            # (stream-affine requests surface the busy instead)
            inf.failovers += 1
            with self._lock:
                self._stats.spillovers += 1
            try:
                self._dispatch(inf, exclude=(rid,))
            except ServeBusy as busy:
                if not inf.outer.done():
                    inf.outer.set_exception(busy)
            return
        with self._lock:
            if isinstance(exc, ServeTimeout):
                self._stats.cancelled += 1
            else:
                self._stats.failed += 1
        if not inf.outer.done():
            inf.outer.set_exception(exc)

    # -- observability -------------------------------------------------------
    def slo_summary(self) -> dict:
        """Fleet-level SLO rollup (the JAX fleet's ``fleet_*`` keys)."""
        with self._lock:
            st = self._stats
            lat = np.asarray(st.latency_ms, dtype=float)
            span = ((st.t_last - st.t_first)
                    if st.t_last is not None and st.t_first is not None
                    else 0.0)
            qps = st.completed / span if span > 0 else 0.0
            out = {
                "fleet_replicas": len(self.replicas),
                "fleet_replicas_alive": len(self.alive_replicas()),
                "fleet_requests": st.completed,
                "fleet_failed": st.failed,
                "fleet_rejected": st.rejected,
                "fleet_qps": round(qps, 3),
                "fleet_qps_per_chip": round(qps / self.n_chips, 3),
                "fleet_p50_ms": round(float(np.percentile(lat, 50)), 3)
                if lat.size else 0.0,
                "fleet_p99_ms": round(float(np.percentile(lat, 99)), 3)
                if lat.size else 0.0,
                "fleet_failovers": st.failovers,
                "fleet_spillovers": st.spillovers,
                "fleet_timeouts": st.cancelled,
                "fleet_joins": st.joins,
                "fleet_drains": st.drains,
                # derived, not the router's counter: a death the transport
                # alone detected must show here too
                "fleet_replica_deaths": (len(self.replicas)
                                         - len(self.alive_replicas())),
                # the affinity health metric: the share of completed
                # requests served by their spec's ring owner
                "fleet_warm_hit_rate": round(
                    st.owner_served / st.completed, 4)
                if st.completed else 0.0,
            }
        # per-replica pool health where the transport exposes it (local
        # pools always; socket replicas answer the `stats` protocol kind)
        compiles = retraces = 0
        seen = 0
        for r in list(self.replicas.values()):
            if not r.alive:
                continue
            try:
                s = (r.slo_summary() if hasattr(r, "slo_summary")
                     else r.stats(timeout=30.0))
            except (ServeError, OSError, RuntimeError,
                    concurrent.futures.TimeoutError):
                continue
            if not isinstance(s, dict) or "serve_steady_compiles" not in s:
                continue
            seen += 1
            compiles += int(s.get("serve_steady_compiles", 0))
            retraces += int(s.get("serve_retraces", 0))
        if seen:
            out["fleet_steady_compiles"] = compiles
            out["fleet_retraces"] = retraces
        hm = self.health
        if hm is not None:
            out.update(hm.stats())
        return out

    def reset_stats(self) -> None:
        """Zero the router's SLO accumulators (the load generator's
        warm-up / measure boundary); in-process pools reset theirs too."""
        with self._lock:
            self._stats = _FleetStats(self.config.result_window)
            self._timeline.clear()
            self._t0 = now()
        if self.health is not None:
            self.health.reset_counters()
        for r in list(self.replicas.values()):
            if isinstance(r, LocalReplica) and r.alive:
                r.pool.reset_stats()

    def report(self):
        """Fleet-level RunReport (kind ``serve_fleet``): the router's SLO
        rollup and its route spans; per-replica reports merge into a
        pid-lane trace via :meth:`replica_reports` and ``obs trace``."""
        from ..obs.report import RunReport

        meta = {
            "kind": "serve_fleet",
            "replicas": len(self.replicas),
            "n_chips": self.n_chips,
            "extra_metrics": self.slo_summary(),
        }
        rep = RunReport(meta=meta)
        with self._lock:
            timeline = list(self._timeline)
        rep.timeline = sorted(timeline, key=lambda e: e.get("t0", 0.0))
        return rep

    def replica_reports(self) -> List:
        """Per-replica RunReports (in-process transports), each stamped
        with its ``process_index``: ``obs.trace.build_trace`` renders them
        as one timeline with a pid lane per replica (socket replicas write
        the same artifact through ``--report``)."""
        return [r.report() for r in list(self.replicas.values())
                if hasattr(r, "report") and r.alive]

    # -- posterior-as-a-service ---------------------------------------------
    def start_session(self, sess: "SampleSessionSpec",
                      checkpoint) -> "SamplingSession":
        """Open a sampling session with replica affinity (the session's
        hash routes it like any spec) and ``checkpoint`` as the migration
        unit on failover."""
        return SamplingSession(self, sess, checkpoint)

    # -- health plane --------------------------------------------------------
    def enable_health(self, config=None):
        """Start the heartbeat monitor (:mod:`.health`): out-of-band
        ``ping`` probes classify replicas healthy / suspect / wedged / dead
        and open a circuit breaker BEFORE user traffic times out into a
        wedged replica; the probe loop doubles as the telemetry scraper.
        Idempotent; stopped by :meth:`close`."""
        from .health import HealthMonitor

        if self.health is None:
            self.health = HealthMonitor(
                self, config, aggregator=self.telemetry).start()
        return self.health

    # -- telemetry plane -----------------------------------------------------
    def telemetry_rollup(self) -> dict:
        """The fleet-wide windowed rollup (``obs top``'s data)."""
        return self.telemetry.rollup()

    def metrics_text(self) -> str:
        """Prometheus text exposition of the fleet rollup."""
        from ..obs import promfmt
        return promfmt.render(self.telemetry.rollup())

    # -- elastic membership --------------------------------------------------
    def join(self, replica, prewarm: bool = True,
             warm_timeout_s: float = 300.0) -> dict:
        """Adopt ``replica`` into the ring: compute the ~1/N shard the
        post-join ring routes to it, prewarm that shard's served working
        set directly on the replica (its kernels come from the shared
        build directory: no nvcc), then add it to the membership under
        the lock. Prewarm happens BEFORE the ring flips, so no request
        lands on a cold shard."""
        with self._lock:
            if self._closed:
                raise ServeClosed("fleet is closed")
            if replica.id in self.replicas:
                raise ValueError(
                    f"replica {replica.id!r} is already in the fleet")
            existing = list(self.replicas)
            recent = [(sh, spec, tuple(sorted(buckets)))
                      for sh, (spec, buckets) in self._recent.items()]
        warm_loads = 0
        if prewarm and recent:
            tmp = HashRing(existing + [replica.id],
                           vnodes=self.config.vnodes)
            for sh, spec, buckets in recent:
                if tmp.owner(sh) != replica.id:
                    continue
                for b in buckets:
                    try:
                        replica.submit(
                            SimRequest(spec=spec, n=int(b), seed=0)
                        ).result(timeout=warm_timeout_s)
                        warm_loads += 1
                    except (ServeError, OSError, RuntimeError) as exc:
                        flightrec.note("fleet_join_prewarm_failed",
                                       replica=replica.id,
                                       error=repr(exc)[:160])
        with self._lock:
            self.replicas[replica.id] = replica
            self.ring.add(replica.id)
            self._stats.joins += 1
        metrics.count("fleet.joins")
        flightrec.note("fleet_join", replica=replica.id,
                       warm_loads=warm_loads, replicas=len(self.replicas))
        return {"replica": replica.id, "warm_loads": warm_loads}

    def retire(self, rid: str, drain_timeout_s: float = 60.0) -> None:
        """Graceful leave: pull ``rid`` off the ring first (its shard
        remaps ~1/N to the survivors), drain its in-flight work with a
        bounded wait, then close it. Sampling and stream sessions resume
        on the shard's new owner from their checkpoint boundaries."""
        with self._lock:
            r = self.replicas.get(rid)
            if r is None:
                raise ValueError(f"replica {rid!r} is not in the fleet")
            live = [x for x in self.replicas.values() if x.alive]
            if r.alive and len(live) <= 1:
                raise ServeError("cannot retire the last live replica")
            self.ring.remove(rid)
        deadline = now() + drain_timeout_s
        drained = False
        while now() < deadline:
            with self._lock:
                if self._inflight[rid] <= 0:
                    drained = True
                    break
            time.sleep(0.01)
        if not drained:
            flightrec.note("fleet_drain_timeout", replica=rid,
                           timeout_s=drain_timeout_s)
        with self._lock:
            self.replicas.pop(rid, None)
            self._stats.drains += 1
        if self.health is not None:
            self.health.forget(rid)
        # the replica's telemetry window is frozen under `retired`, not
        # dropped
        self.telemetry.retire(rid)
        metrics.count("fleet.drains")
        flightrec.note("fleet_drain", replica=rid, drained=bool(drained),
                       replicas=len(self.replicas))
        try:
            r.close()
        except (ServeError, OSError, RuntimeError) as exc:
            flightrec.note("fleet_replica_close_failed", replica=rid,
                           error=repr(exc)[:160])

    def listen(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """The replica-join handshake listener: a ``serve replica
        --register HOST:PORT`` process dials this socket, sends one JSON
        ``hello`` line (its serving port and identity), and is adopted via
        :class:`SocketReplica` attach mode and :meth:`join`; the reply
        line is ``adopt`` (or ``reject`` with the error). Returns the
        bound admin port. Idempotent."""
        if self._admin_sock is not None:
            return self._admin_sock.getsockname()[1]
        srv = socket.create_server((host, port))
        srv.settimeout(0.25)       # bounded accept: close() can stop us
        self._admin_sock = srv
        self._admin_thread = threading.Thread(
            target=self._admin_loop, name="fleet-admin", daemon=True)
        self._admin_thread.start()
        admin_port = srv.getsockname()[1]
        flightrec.note("fleet_listen", port=admin_port)
        return admin_port

    def _admin_loop(self) -> None:
        while True:
            with self._lock:
                if self._closed:
                    return
            try:
                conn, addr = self._admin_sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return                    # listener closed
            try:
                self._adopt(conn, addr)
            except (ServeError, OSError, ValueError, RuntimeError,
                    KeyError) as exc:
                flightrec.note("fleet_adopt_failed", error=repr(exc)[:200])
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def _adopt(self, conn, addr) -> None:
        conn.settimeout(30.0)
        raw = conn.makefile("rb").readline(MAX_LINE_BYTES + 1)
        hello = json.loads(raw.decode("utf-8", "replace"))
        if hello.get("event") != "hello" or "port" not in hello:
            conn.sendall((json.dumps(
                {"event": "reject", "error": "bad hello"}) + "\n").encode())
            raise ValueError(f"bad hello line: {raw[:200]!r}")
        rid = str(hello.get("replica_id") or f"joined-{hello['port']}")
        try:
            rep = SocketReplica(rid,
                                connect=(addr[0], int(hello["port"])),
                                index=int(hello.get("index", 0)),
                                n_devices=int(hello.get("n_devices", 1)))
            self.join(rep)
        except BaseException as exc:
            conn.sendall((json.dumps(
                {"event": "reject",
                 "error": repr(exc)[:200]}) + "\n").encode())
            raise
        conn.sendall((json.dumps(
            {"event": "adopt", "replica_id": rid,
             "replicas": len(self.replicas)}) + "\n").encode())

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self.health is not None:
            self.health.stop()
        if self._admin_sock is not None:
            try:
                self._admin_sock.close()
            except OSError:
                pass
            t = self._admin_thread
            if t is not None:
                t.join(5.0)
                if t.is_alive():
                    flightrec.note("fleet_admin_join_timeout")
        for r in list(self.replicas.values()):
            try:
                r.close()
            except (ServeError, OSError, RuntimeError) as exc:
                flightrec.note("fleet_replica_close_failed", replica=r.id,
                               error=repr(exc)[:160])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# posterior-as-a-service
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SampleSessionSpec:
    """A JSON-expressible long-running sampling session: a synthetic array
    (:class:`ArraySpec`, the data side) posterior-sampled under a CURN
    free-spectrum model. Every field is a plain scalar, so the session
    request crosses the socket protocol verbatim (the ``sample`` kind)
    and hashes as the JAX package's does."""

    spec: ArraySpec
    n_steps: int = 32
    seed: int = 0
    segment: Optional[int] = None
    nbin: int = 3
    n_chains: int = 4
    n_temps: int = 1
    warmup: int = 8
    thin: int = 1
    step_size: float = 0.3
    n_leapfrog: int = 4
    data_seed: int = 0
    #: factorized bin-lane routing (sample/factorized.py): this session
    #: samples only free-spectrum bins [bin_offset, bin_offset + nbin) ...
    bin_offset: int = 0
    #: ... of a PARENT model with this many bins: the replica synthesizes
    #: the session's residuals from the parent model, so every lane of one
    #: factorized run (and a local run of the same lane) samples the
    #: IDENTICAL data vector. None = an ordinary joint session.
    data_nbin: Optional[int] = None

    def _model(self, nbin: int, bin_offset: int = 0):
        from ..infer import ComponentSpec, FreeParam, LikelihoodSpec

        return LikelihoodSpec(components=(
            ComponentSpec(target="red", spectrum="batch"),
            ComponentSpec(target="dm", spectrum="batch"),
            ComponentSpec(target="curn", nbin=nbin, bin_offset=bin_offset,
                          spectrum="free_spectrum",
                          free=(FreeParam("log10_rho", (-9.0, -5.0),
                                          per_bin=True),)),
        ))

    def sample_spec(self):
        from ..sample import SampleSpec

        model = self._model(self.nbin, self.bin_offset)
        return SampleSpec(model=model, n_chains=self.n_chains,
                          n_temps=self.n_temps, warmup=self.warmup,
                          thin=self.thin, step_size=self.step_size,
                          n_leapfrog=self.n_leapfrog)

    def session_hash(self) -> str:
        d = dataclasses.asdict(self)
        d["spec"] = self.spec.spec_dict()
        d["kind"] = "SampleSession"
        return flightrec.spec_hash(d)


def build_session_run(sess: "SampleSessionSpec", mesh,
                      compile_cache_dir=None):
    """Construct a session's :class:`..sample.SamplingRun` on ``mesh``:
    the ONE construction path shared by :meth:`LocalReplica.sampling_run`
    and the socket protocol's ``sample`` kind, so a lane routed anywhere
    in the fleet builds the run a solo caller would.

    For a factorized bin-lane session (``data_nbin`` set) the replica
    reproduces a local :class:`..sample.FactorizedRun` lane: residuals are
    synthesized from the PARENT model at ``data_seed``, the parent moments
    staged and the pinned components marginalized
    (:func:`..sample.factorized.marginalized_window_moments`), and the run
    is built over the lane-only model with those moments injected, so a
    lane's draws are bit-identical whichever replica hosts it.
    """
    from ..infer import model as infer_model
    from ..sample import SamplingRun
    from ..sample.factorized import marginalized_window_moments
    from ..sample.run import stage_moments, synthesize_residuals

    no_compile_cache(compile_cache_dir)
    batch, _gwb = sess.spec.parts(device=mesh.local_device)
    if sess.data_nbin is not None:
        parent = infer_model.build(sess._model(int(sess.data_nbin)), batch)
        truth = parent.theta_from_unit(np.full(parent.D, 0.5))
        residuals = synthesize_residuals(parent, batch, truth,
                                         sess.data_seed)
        mom = stage_moments(parent, batch, residuals)
        lo = int(sess.bin_offset)
        lane_mom = marginalized_window_moments(parent, batch, mom, lo,
                                               lo + int(sess.nbin))
        free_comp = next(c for c in parent.spec.components if c.free)
        lane_comp = dataclasses.replace(free_comp, nbin=int(sess.nbin),
                                        bin_offset=lo)
        lane_spec = dataclasses.replace(
            sess.sample_spec(),
            model=type(parent.spec)(components=(lane_comp,)))
        return SamplingRun(batch, lane_spec, mesh=mesh, moments=lane_mom,
                           data_seed=sess.data_seed)
    return SamplingRun(batch, sess.sample_spec(), mesh=mesh,
                       data_seed=sess.data_seed)


class SamplingSession:
    """One long-running posterior run with replica affinity and failover.

    The session routes to its hash's ring owner and runs there segment by
    segment with a checkpoint at every segment boundary. A replica death
    mid-run (an injected ``sample.segment`` / ``fleet.replica`` kill, a
    lost process) migrates the session to the ring's next live sibling,
    which **resumes from the checkpoint**; segment resume is bit-exact
    across meshes, so the migrated chains are bit-identical to an
    uninterrupted run. ``on_segment`` receives each post-warmup segment's
    thinned draws as it drains.
    """

    def __init__(self, fleet: ServeFleet, sess: SampleSessionSpec,
                 checkpoint):
        self.fleet = fleet
        self.sess = sess
        self.checkpoint = Path(checkpoint)
        self.session_hash = sess.session_hash()
        self.migrations = 0
        with fleet._lock:
            self.replica_id = fleet.ring.owner(self.session_hash)

    def _next_replica(self, exclude):
        with self.fleet._lock:
            pref = list(self.fleet.ring.preference(self.session_hash))
        for rid in pref:
            r = self.fleet.replicas.get(rid)
            if (r is not None and r.alive and rid not in exclude
                    and hasattr(r, "sampling_run")):
                return rid
        raise ServeError("no live replica can host the sampling session")

    def run(self, on_segment=None, pipeline_depth: int = 0) -> dict:
        """Drive the session to completion (synchronously). Returns the
        :meth:`..sample.SamplingRun.run` result plus ``session``
        bookkeeping."""
        tried: list = []
        while True:
            rid = self._next_replica(tried)
            self.replica_id = rid
            replica = self.fleet.replicas[rid]
            flightrec.note("fleet_session_assign", session=self.session_hash,
                           replica=rid, migrations=self.migrations)
            try:
                run = replica.sampling_run(self.sess)
                out = run.run(self.sess.n_steps, seed=self.sess.seed,
                              segment=self.sess.segment,
                              checkpoint=str(self.checkpoint),
                              pipeline_depth=pipeline_depth,
                              on_segment=on_segment)
                out["session"] = {"hash": self.session_hash,
                                  "replica": rid,
                                  "migrations": self.migrations}
                return out
            except BaseException as exc:   # noqa: BLE001 — triaged: only
                # replica-death verdicts migrate, everything else re-raises
                if (faults_mod.classify_replica(exc) != "replica_death"
                        or self.migrations
                        >= self.fleet.config.max_failovers):
                    raise
                self.fleet._mark_dead(rid, repr(exc))
                tried.append(rid)
                self.migrations += 1
                flightrec.note("fleet_session_migrate",
                               session=self.session_hash, from_replica=rid,
                               attempt=self.migrations)
