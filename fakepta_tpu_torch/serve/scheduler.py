"""Microbatch coalescing scheduler and the :class:`ServePool` facade (port
of ``fakepta_tpu.serve.scheduler``).

One chunk dispatch and one device round trip amortize across as many
users as the queue holds. Requests are admitted into per-``(spec_hash,
lane token)`` queues, coalesced into cohorts inside a short window, padded
up to a fixed **bucket ladder** shape (every bucket is warmed once, so a
dispatch builds no kernel), dispatched through
``EnsembleSimulator.run(lanes=...)`` with one RNG **lane** per request,
and demultiplexed into per-request slices on a demux thread. A response is
bit-identical to the same request served alone at the same bucket, and
within the path's tolerance of its own solo ``run(n, seed)``.

Robustness is part of the lane:

- **backpressure**: admission past ``max_queue_depth`` pending requests
  raises :class:`ServeBusy` (429-style, with a ``retry_after_s`` hint);
  the demux hand-off queue is bounded too, so a slow consumer throttles
  dispatch instead of growing host memory;
- **deadlines**: a request whose relative ``deadline_s`` expires before
  its cohort dispatches is cancelled with :class:`ServeTimeout`
  (dispatched work always completes);
- **recovery**: a transient dispatch failure (``faults.classify``) is
  retried with bounded backoff; non-finite output evicts the entry from
  the warm pool and re-dispatches the cohort once, on the same kernels; a
  kernel build or launch failure, or a sticky CUDA error, fails the cohort
  with :class:`ServeError` (never retried, never served on a plain
  version);
- **failure telemetry**: every failure leaves a flight-recorder note.

Threads and the card: the dispatcher thread does all device work (it
sets its current CUDA device to the mesh's), and ``run()`` returns host
numpy, so the demux thread only slices host arrays.

Observability: every request contributes a timeline span, and the pool
rolls them up into SLO summaries (``serve_p50_ms`` / ``serve_p99_ms`` /
``serve_qps_per_chip``, ``queue_depth``, ``coalesce_factor``,
``pad_waste_frac``); :meth:`ServePool.save_report` writes a RunReport
artifact that ``obs summarize`` prints and ``obs compare`` / ``obs gate``
band. ``serve_steady_compiles`` counts dispatches of an already-warm
(lane, bucket) pair whose report spent seconds building kernels
(``RunReport.compile_s``): after warm-up it stays 0.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
from concurrent.futures import Future
from typing import Optional, Tuple

import numpy as np

from .. import faults as faults_mod
from ..device import DeviceLike
from ..obs import flightrec, metrics
from ..obs.timing import now
from ..ops import binned_corr as bc
from .pool import WarmPool
from .spec import (DEFAULT_BUCKETS, ServeBusy, ServeClosed, ServeError,
                   ServeTimeout, SimRequest, resolve_spec_hash)

_STOP = object()

#: shutdown join bound: generous against any legitimate drain, but finite
_SHUTDOWN_JOIN_S = 60.0

class _PoisonedOutput(RuntimeError):
    """A dispatch returned non-finite statistics: recovery evicts the
    entry and re-dispatches once."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Scheduler and pool knobs (the JAX package's, value for value).

    ``buckets`` is the microbatch ladder: cohorts pad to the smallest
    bucket >= their total realization count. ``max_queue_depth`` bounds
    the pending-request count across all queues (admission past it raises
    ServeBusy). ``coalesce_window_s`` is how long the scheduler holds the
    oldest request to let batchmates arrive; a full max-size cohort
    dispatches immediately. ``prewarm_buckets`` (default: none) warms the
    plain-sim lane for those buckets when a spec is registered.
    """

    buckets: Tuple[int, ...] = DEFAULT_BUCKETS
    max_queue_depth: int = 256
    coalesce_window_s: float = 0.002
    max_specs: int = 4
    prewarm_buckets: Tuple[int, ...] = ()
    pipeline_depth: int = 0          # single-chunk dispatches: serial loop
    result_window: int = 4096        # SLO ring capacity (requests)
    # recovery: transient dispatch failures retry with bounded backoff
    # before the cohort is failed; non-finite output evicts the entry and
    # re-dispatches the cohort once
    max_dispatch_retries: int = 2
    retry_backoff_s: float = 0.05


@dataclasses.dataclass
class ServeResult:
    """One request's demultiplexed slice of its cohort dispatch."""

    curves: np.ndarray               # (n, nbins)
    autos: np.ndarray                # (n,)
    bin_centers: np.ndarray
    os: Optional[dict] = None        # per-request detect assembly
    lnlike: Optional[dict] = None    # per-request infer lanes
    queued_s: float = 0.0            # admission -> dispatch
    service_s: float = 0.0           # dispatch -> result ready
    latency_s: float = 0.0           # admission -> result ready
    cohort_requests: int = 1         # how many requests rode the dispatch
    bucket: int = 0                  # padded dispatch shape
    pad_waste_frac: float = 0.0      # 1 - cohort realizations / bucket
    # fleet routing facts: which replica served it, and how many
    # mid-flight failovers the request survived (0 = first try)
    replica: str = ""
    failovers: int = 0


class _Pending:
    __slots__ = ("req", "fut", "spec_hash", "cohort_key", "t_enq",
                 "deadline")

    def __init__(self, req, fut, spec_hash, cohort_key, t_enq, deadline):
        self.req = req
        self.fut = fut
        self.spec_hash = spec_hash
        self.cohort_key = cohort_key
        self.t_enq = t_enq
        self.deadline = deadline


class _CohortQueue:
    """FIFO of pending requests plus an O(1) realization total, so the
    dispatcher's window check never rescans the queue under the lock."""

    __slots__ = ("q", "total", "min_deadline")

    def __init__(self, maxlen: int):
        self.q = collections.deque(maxlen=maxlen)
        self.total = 0
        # earliest deadline ever queued here: conservative (never relaxed
        # on pop), so a deadline never sleeps through its coalesce window
        self.min_deadline = None

    def append(self, p) -> None:
        self.q.append(p)
        self.total += int(p.req.n)
        if p.deadline is not None and (self.min_deadline is None
                                       or p.deadline < self.min_deadline):
            self.min_deadline = p.deadline

    def popleft(self):
        p = self.q.popleft()
        self.total -= int(p.req.n)
        return p

    def __bool__(self) -> bool:
        return bool(self.q)

    def __len__(self) -> int:
        return len(self.q)


class _Stats:
    """SLO accumulators (bounded rings; guarded by the pool lock)."""

    def __init__(self, window: int):
        self.latency_ms = collections.deque(maxlen=window)
        self.queued_ms = collections.deque(maxlen=window)
        self.service_ms = collections.deque(maxlen=window)
        self.coalesce = collections.deque(maxlen=window)
        self.pad_waste = collections.deque(maxlen=window)
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.cancelled = 0
        self.failed = 0
        self.retried = 0             # transient dispatch retries
        self.evicted = 0             # poisoned-output evictions
        self.dispatches = 0
        self.realizations = 0
        self.queue_depth_max = 0
        self.retraces = 0
        self.steady_compiles = 0     # kernel builds on an already-warm pair
        self.warm_s = 0.0
        self.t_first = None          # first admission
        self.t_last = None           # last completion


def _launch_counts() -> dict:
    """Every kernel wrapper's launch count in this process."""
    from ..ops import megakernel as mk

    return {"binned_correlation": bc.launches,
            "binned_correlation_vpu": bc.vpu_launches,
            "chunk_stats": mk.launches,
            "chunk_stats_sharded": mk.sharded_launches}


def _pool_mesh(mesh, device: DeviceLike):
    """The pool's mesh: the one given, else a one-entry mesh on
    ``device`` (default ``"cuda"``: without a GPU this raises)."""
    from ..parallel.mesh import make_mesh

    if mesh is not None:
        if device is not None:
            raise ValueError("pass mesh= or device=, not both")
        return mesh
    return make_mesh(["cuda" if device is None else device])


class ServePool:
    """The embeddable serving facade.

    One dispatcher thread forms cohorts and drives the device; one demux
    thread slices results and resolves futures, so result assembly for
    cohort *k* overlaps the dispatch of cohort *k+1*.

    ``mesh``: the mesh every spec's simulator is built on; by default a
    one-entry mesh on ``device`` (default ``"cuda"``; pass
    ``device="cpu"`` to serve on the CPU). The JAX pool meshes every
    visible device. ``tuned=True`` takes the tuner store's bucket ladder
    for the mesh's devices (:func:`..tune.resolve_buckets`).

    >>> pool = ServePool()
    >>> res = pool.serve(SimRequest(spec=ArraySpec(npsr=8), n=32, seed=7))
    >>> pool.close()
    """

    def __init__(self, mesh=None, config: Optional[ServeConfig] = None,
                 tuned: bool = False, device: DeviceLike = None):
        self.config = config or ServeConfig()
        mesh = _pool_mesh(mesh, device)
        self.mesh = mesh
        # distinct devices: a mesh may list one card several times
        self.n_devices = len(set(zip(mesh.ranks.flat, mesh.devices.flat)))
        n_real = int(mesh.shape.get("real", 1))
        if tuned:
            # the tuner's platform ladder replaces the hand-set one and
            # becomes the prewarm set when none was configured; a store
            # miss keeps the hand-set ladder, with a note
            from .. import tune as tune_mod
            from ..tune.search import mesh_entries
            ladder = tune_mod.resolve_buckets(devices=mesh_entries(mesh))
            if ladder:
                legal = tuple(b for b in ladder if b % max(n_real, 1) == 0)
                if legal:
                    self.config = dataclasses.replace(
                        self.config, buckets=legal,
                        prewarm_buckets=(self.config.prewarm_buckets
                                         or legal))
                    flightrec.note("serve_tuned_buckets",
                                   buckets=list(legal))
            else:
                flightrec.note("serve_tuned_miss")
        buckets = sorted({int(b) for b in self.config.buckets})
        bad = [b for b in buckets if b % n_real]
        if bad or not buckets:
            raise ValueError(
                f"every bucket must be a positive multiple of the mesh's "
                f"'real' axis ({n_real}); offending buckets: {bad or buckets}")
        self._buckets = tuple(buckets)
        self._max_bucket = buckets[-1]
        self._pool = WarmPool(mesh, max_entries=self.config.max_specs)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queues: dict = {}          # cohort_key -> _CohortQueue
        self._pending = 0
        self._closed = False
        self._t0 = now()                 # pool epoch for timeline spans
        self._stats = _Stats(self.config.result_window)
        self._timeline = collections.deque(maxlen=self.config.result_window)
        # bounded hand-off to the demux thread
        self._demux_q: "queue.Queue" = queue.Queue(maxsize=8)
        self._demux_thread = threading.Thread(
            target=self._demux_loop, name="fakepta-serve-demux", daemon=True)
        self._demux_thread.start()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="fakepta-serve-dispatch",
            daemon=True)
        self._dispatcher.start()
        # the replica-side telemetry publisher: costs nothing until
        # something scrapes it
        from ..obs import telemetry as telemetry_mod
        self.telemetry = telemetry_mod.TelemetryPublisher()
        self.telemetry.add_source("slo", self.slo_summary)
        self.telemetry.add_source("pool", self.warm_summary)
        self.telemetry.add_source("streams", self.stream_summary)
        self.telemetry.add_source("health", self.health_summary)
        # lazy single-replica aggregator behind metrics_text
        self._metrics_agg = None
        self._stream_mgr = None          # lazy StreamManager (streams.py)
        # kernel -> {bucket: launches} of this pool's dispatches
        self._launches_by_bucket: dict = {}

    # -- registration / admission ------------------------------------------
    def register(self, name: str, sim, prewarm: bool = True) -> str:
        """Pin a prebuilt simulator under ``name`` (multi-tenant surface);
        requests then pass ``spec=name``. Returns the spec hash. With
        ``prewarm_buckets`` configured, the warm-up runs here, on the
        caller's thread."""
        spec_hash = self._pool.register(name, sim)
        if prewarm and self.config.prewarm_buckets:
            entry = self._pool.get(spec_hash, None)
            self._stats.warm_s += self._pool.prewarm(
                entry, self.config.prewarm_buckets)
        return spec_hash

    def submit(self, req: SimRequest) -> Future:
        """Admit one request; returns a Future resolving to a
        :class:`ServeResult`. Raises :class:`ServeBusy` past the configured
        queue depth, :class:`ServeClosed` after shutdown, ``ValueError``
        for an unserveable shape. Stream-affine kinds bypass the
        scheduler (:meth:`_submit_stream`)."""
        if getattr(req, "stream_affine", False):
            # nothing to coalesce (an append mutates ONE stream, in
            # order): executed synchronously under the StreamManager's
            # per-stream lock
            return self._submit_stream(req)
        n = int(req.n)
        if not 0 < n <= self._max_bucket:
            raise ValueError(
                f"request n={n} does not fit the bucket ladder (max "
                f"{self._max_bucket}); split the request or extend "
                f"ServeConfig.buckets")
        spec_hash = resolve_spec_hash(req.spec, self._pool.named)
        cohort_key = (spec_hash, req.lane_token())
        fut: Future = Future()
        t = now()
        deadline = t + req.deadline_s if req.deadline_s is not None else None
        with self._cond:
            if self._closed:
                raise ServeClosed("pool is closed")
            if self._pending >= self.config.max_queue_depth:
                self._stats.rejected += 1
                hint = self._retry_after_locked()
                flightrec.note("serve_busy", pending=self._pending,
                               depth=self.config.max_queue_depth,
                               retry_after_s=round(hint, 4))
                raise ServeBusy(
                    f"{self._pending} requests pending >= max_queue_depth="
                    f"{self.config.max_queue_depth}; retry in ~{hint:.3f}s",
                    retry_after_s=hint)
            q = self._queues.get(cohort_key)
            if q is None:
                q = _CohortQueue(self.config.max_queue_depth)
                self._queues[cohort_key] = q
            q.append(_Pending(req, fut, spec_hash, cohort_key, t, deadline))
            self._pending += 1
            self._stats.submitted += 1
            if self._stats.t_first is None:
                self._stats.t_first = t
            self._stats.queue_depth_max = max(self._stats.queue_depth_max,
                                              self._pending)
            self._cond.notify_all()
        return fut

    def _submit_stream(self, req) -> Future:
        """Admit and execute one stream-affine request on the pool's
        device. Synchronous, but future-shaped so the fleet transports
        and ``serve()`` treat every kind alike. ServeError subclasses
        raise at the submit site (admission semantics, like ``n``
        validation); anything else resolves the future exceptionally."""
        with self._lock:
            if self._closed:
                raise ServeClosed("pool is closed")
            mgr = self._stream_mgr
            if mgr is None:
                from .streams import StreamManager
                mgr = self._stream_mgr = StreamManager(
                    device=self.mesh.local_device)
        fut: Future = Future()
        try:
            fut.set_result(mgr.handle(req))
        except ServeError:
            raise                      # admission semantics: raise at submit
        except Exception as exc:       # noqa: BLE001 — the future contract
            fut.set_exception(exc)
        metrics.count("serve.stream_requests")
        return fut

    def _retry_after_locked(self) -> float:
        """The ServeBusy backoff hint: dispatches needed to clear the
        queued realizations times the recent mean service time, floored at
        one coalesce window and capped at 5 s. Caller holds the lock."""
        st = self._stats
        mean_service_s = (float(np.mean(st.service_ms)) / 1e3
                          if st.service_ms else
                          self.config.coalesce_window_s)
        backlog = sum(q.total for q in self._queues.values())
        dispatches = max(1, -(-int(backlog) // self._max_bucket))
        return float(min(max(dispatches * mean_service_s,
                             self.config.coalesce_window_s), 5.0))

    def serve(self, req: SimRequest, timeout: Optional[float] = None
              ) -> ServeResult:
        """Blocking convenience: ``submit`` + wait."""
        return self.submit(req).result(timeout=timeout)

    @property
    def buckets(self) -> Tuple[int, ...]:
        """The validated microbatch bucket ladder."""
        return self._buckets

    # -- scheduling ---------------------------------------------------------
    def bucket_for(self, total: int) -> int:
        """Smallest ladder bucket >= ``total`` realizations."""
        for b in self._buckets:
            if b >= total:
                return b
        return self._max_bucket

    def _oldest_key(self):
        best = None
        for key, q in self._queues.items():
            if q and (best is None or q.q[0].t_enq < best[1]):
                best = (key, q.q[0].t_enq)
        return best[0] if best else None

    def _dispatch_loop(self):
        # a dead dispatcher is flight-recorded and every pending future
        # fails loudly with the cause
        try:
            dev = self.mesh.local_device
            if dev.type == "cuda":
                import torch
                # the current device is per thread in torch
                torch.cuda.set_device(dev)
            self._dispatch_loop_inner()
        except BaseException as exc:   # noqa: BLE001 — recorded + failed
            flightrec.note("serve_dispatcher_died", error=repr(exc)[:300])
            err = ServeError(f"serve dispatcher thread died: {exc!r}; "
                             f"queued requests failed, pool is closed")
            err.__cause__ = exc
            # collect under the lock, resolve outside it: completion
            # callbacks run synchronously and may take other locks
            doomed = []
            with self._cond:
                self._closed = True
                for q in self._queues.values():
                    while q:
                        doomed.append(q.popleft())
                self._pending -= len(doomed)
                self._stats.failed += len(doomed)
                self._cond.notify_all()
            for p in doomed:
                p.fut.set_exception(err)
            raise

    def _dispatch_loop_inner(self):
        while True:
            with self._cond:
                while self._pending == 0 and not self._closed:
                    self._cond.wait()
                if self._pending == 0 and self._closed:
                    return
                key = self._oldest_key()
                q = self._queues[key]
                # hold the oldest request one coalesce window so batchmates
                # land in the same dispatch; a ladder-filling cohort (or
                # shutdown drain) goes immediately
                window_end = q.q[0].t_enq + self.config.coalesce_window_s
                while not self._closed and q.total < self._max_bucket:
                    # the window closes early at the earliest queued
                    # deadline, so an expiring request is cancelled promptly
                    t_end = (window_end if q.min_deadline is None
                             else min(window_end, q.min_deadline))
                    t_now = now()
                    if t_now >= t_end:
                        break
                    self._cond.wait(timeout=max(t_end - t_now, 1e-4))
                cohort, expired, total = [], [], 0
                t_now = now()
                while q:
                    p = q.q[0]
                    if p.deadline is not None and t_now > p.deadline:
                        expired.append(q.popleft())
                        continue
                    if total + p.req.n > self._max_bucket:
                        break
                    cohort.append(q.popleft())
                    total += p.req.n
                self._pending -= len(cohort) + len(expired)
                self._stats.cancelled += len(expired)
            for p in expired:
                flightrec.note("serve_deadline_cancel", kind=p.req.kind,
                               n=int(p.req.n), waited_s=round(
                                   now() - p.t_enq, 4))
                p.fut.set_exception(ServeTimeout(
                    f"deadline ({p.req.deadline_s}s) expired before "
                    f"dispatch"))
            if cohort:
                self._dispatch(cohort, total)

    def _dispatch(self, cohort, total: int):
        p0 = cohort[0]
        run_kwargs = p0.req.run_kwargs()
        token = p0.req.lane_token()
        bucket = self.bucket_for(total)
        lanes = [(p.req.seed, p.req.n) for p in cohort]
        t_d0 = now()
        launched0 = bc.thread_launches()
        attempts, evicted = 0, False
        delay = self.config.retry_backoff_s
        while True:
            try:
                # chaos site: the serve dispatcher
                act = faults_mod.check("serve.dispatch",
                                       cohort=len(cohort),
                                       bucket=int(bucket))
                entry = self._pool.get(p0.spec_hash, p0.req.spec)
                warm_s = entry.ensure_warm(bucket, token, run_kwargs)
                out = entry.sim.run(
                    bucket, chunk=bucket, lanes=lanes,
                    pipeline_depth=self.config.pipeline_depth,
                    **run_kwargs)
                if act == "poison":
                    out["curves"] = np.asarray(out["curves"]) * np.nan
                if not np.isfinite(np.asarray(out["curves"])).all():
                    raise _PoisonedOutput(
                        f"dispatch returned non-finite curves at bucket "
                        f"{bucket} (poisoned output)")
                if "os" in run_kwargs and token not in entry.os_ops:
                    # the host-f64 OS operators the demux re-assembles
                    # each request's statistics with, built here so the
                    # demux thread touches no device state
                    entry.os_ops[token] = entry.sim._prepare_lanes(
                        run_kwargs["os"]).ops
                break
            except BaseException as exc:   # noqa: BLE001 — triaged below,
                # forwarded to callers when recovery is exhausted
                if isinstance(exc, _PoisonedOutput) and not evicted:
                    # evict the entry's derived state and re-dispatch ONCE
                    # on the same kernels: the rebuilt entry serves the
                    # same lanes bit-identically
                    flightrec.note("serve_poisoned_executable",
                                   spec=p0.spec_hash, bucket=int(bucket))
                    self._pool.evict(p0.spec_hash)
                    evicted = True
                    with self._lock:
                        self._stats.evicted += 1
                    continue
                if (not isinstance(exc, _PoisonedOutput)
                        and faults_mod.classify(exc) == "transient"
                        and attempts < self.config.max_dispatch_retries):
                    attempts += 1
                    flightrec.note("serve_dispatch_retry",
                                   attempt=attempts,
                                   error=repr(exc)[:200])
                    with self._lock:
                        self._stats.retried += 1
                    faults_mod.sleep(delay)
                    delay = min(delay * 2.0, 2.0)
                    continue
                flightrec.note("serve_request_failed", kind=p0.req.kind,
                               cohort=len(cohort), bucket=int(bucket),
                               error=repr(exc)[:300])
                err = ServeError(f"dispatch failed: {exc!r}")
                err.__cause__ = exc
                with self._lock:
                    self._stats.failed += len(cohort)
                for p in cohort:
                    p.fut.set_exception(err)
                if not isinstance(exc, Exception):
                    # a simulated kill or interpreter shutdown: the cohort
                    # is failed above, then the dispatcher itself dies and
                    # _dispatch_loop fails every still-queued request
                    raise
                return
        t_d1 = now()
        rep = out["report"]
        # this thread's launches: a sibling pool in the process is not
        # counted
        launched = {k: n - launched0.get(k, 0)
                    for k, n in bc.thread_launches().items()
                    if n > launched0.get(k, 0)}
        with self._lock:
            st = self._stats
            for k, n in launched.items():
                by = self._launches_by_bucket.setdefault(k, {})
                by[int(bucket)] = by.get(int(bucket), 0) + n
            st.dispatches += 1
            st.realizations += total
            st.coalesce.append(len(cohort))
            st.pad_waste.append(1.0 - total / bucket)
            st.retraces += rep.retraces
            st.warm_s += warm_s
            if warm_s == 0.0 and rep.compile_s > 0:
                # an already-warm (lane, bucket) pair built a kernel: the
                # steady-state build the warm pool exists to prevent
                st.steady_compiles += 1
            ev = {"name": "serve_dispatch", "tid": "serve",
                  "t0": t_d0 - self._t0, "dur": t_d1 - t_d0,
                  "cohort": len(cohort), "bucket": int(bucket),
                  "req_kind": p0.req.kind}
            # the cohort span carries every member's trace_id
            traced = [p.req.trace_id for p in cohort
                      if getattr(p.req, "trace_id", None)]
            if traced:
                ev["trace_ids"] = traced
            self._timeline.append(ev)
        self._demux_q.put((cohort, out, entry, run_kwargs, bucket, total,
                           t_d0, t_d1))

    # -- demux --------------------------------------------------------------
    def _demux_loop(self):
        while True:
            item = self._demux_q.get()
            if item is _STOP:
                return
            cohort, out, entry, run_kwargs, bucket, total, t_d0, t_d1 = item
            try:
                self._demux(cohort, out, entry, run_kwargs, bucket, total,
                            t_d0)
            except BaseException as exc:   # noqa: BLE001 — forwarded
                err = ServeError(f"demux failed: {exc!r}")
                err.__cause__ = exc
                for p in cohort:
                    if not p.fut.done():
                        p.fut.set_exception(err)
                flightrec.note("serve_demux_failed", error=repr(exc)[:300])
                with self._lock:
                    self._stats.failed += sum(
                        1 for p in cohort if p.fut.exception() is err)

    def _demux(self, cohort, out, entry, run_kwargs, bucket, total, t_d0):
        os_vals = null_vals = os_ops = os_spec = None
        if out.get("os") is not None:
            from ..detect import operators as detect_ops

            res = out["os"]
            os_spec = run_kwargs["os"]
            # the engine's assembly is per-realization except the null
            # calibration (quantiles and p-values over the cohort's null
            # sample); re-assembling each request's slice keeps every
            # response a function of its own lane
            os_vals = np.stack([res["stats"][o]["amp2"] for o in res["orfs"]],
                               axis=1)
            if res["null"]:
                null_vals = np.stack([res["stats"][o]["null_amp2"]
                                      for o in res["orfs"]], axis=1)
            os_ops = entry.os_ops[cohort[0].req.lane_token()]
            assemble = detect_ops.assemble
        pos = 0
        done = []
        for p in cohort:
            n = int(p.req.n)
            sl = slice(pos, pos + n)
            pos += n
            result = ServeResult(
                curves=np.array(out["curves"][sl]),
                autos=np.array(out["autos"][sl]),
                bin_centers=out["bin_centers"],
                cohort_requests=len(cohort), bucket=int(bucket),
                pad_waste_frac=1.0 - total / bucket)
            if os_vals is not None:
                result.os = assemble(
                    os_spec, os_ops, os_vals[sl],
                    null_vals[sl] if null_vals is not None else None)
            if out.get("lnlike") is not None:
                lnl = out["lnlike"]
                # only the per-realization lanes slice; theta, param_names
                # and schema pass through
                result.lnlike = {k: (np.array(v[sl])
                                     if k in ("lnl", "grad", "fisher")
                                     else v)
                                 for k, v in lnl.items()}
            t_done = now()
            result.queued_s = t_d0 - p.t_enq
            result.service_s = t_done - t_d0
            result.latency_s = t_done - p.t_enq
            p.fut.set_result(result)
            done.append((p, result, t_done))
        # ONE stats/timeline critical section per cohort, after every
        # future is resolved
        with self._lock:
            st = self._stats
            for p, result, t_done in done:
                st.completed += 1
                st.t_last = t_done
                st.latency_ms.append(result.latency_s * 1e3)
                st.queued_ms.append(result.queued_s * 1e3)
                st.service_ms.append(result.service_s * 1e3)
                ev = {"name": "request", "tid": "serve",
                      "t0": p.t_enq - self._t0, "dur": result.latency_s,
                      "req_kind": p.req.kind, "n": int(p.req.n)}
                if getattr(p.req, "trace_id", None):
                    ev["trace_id"] = p.req.trace_id
                self._timeline.append(ev)

    def reset_stats(self) -> None:
        """Zero the SLO accumulators and timeline (the load generator's
        warmup/measure boundary); warm-pool state is untouched."""
        with self._lock:
            self._stats = _Stats(self.config.result_window)
            self._timeline.clear()
            self._t0 = now()

    # -- observability -------------------------------------------------------
    def slo_summary(self) -> dict:
        """The SLO rollup (the JAX package's keys)."""
        with self._lock:
            st = self._stats
            lat = np.asarray(st.latency_ms, dtype=float)
            span = ((st.t_last - st.t_first)
                    if st.t_last is not None and st.t_first is not None
                    else 0.0)
            qps = st.completed / span if span > 0 else 0.0
            out = {
                "serve_requests": st.completed,
                "serve_rejected": st.rejected,
                "serve_deadline_cancelled": st.cancelled,
                "serve_failed": st.failed,
                "serve_dispatches": st.dispatches,
                "serve_realizations": st.realizations,
                "serve_qps_per_chip": round(qps / self.n_devices, 3),
                "serve_real_per_s_per_chip": round(
                    st.realizations / span / self.n_devices
                    if span > 0 else 0.0, 3),
                "serve_p50_ms": round(float(np.percentile(lat, 50)), 3)
                if lat.size else 0.0,
                "serve_p99_ms": round(float(np.percentile(lat, 99)), 3)
                if lat.size else 0.0,
                "coalesce_factor": round(float(np.mean(st.coalesce)), 3)
                if st.coalesce else 0.0,
                "pad_waste_frac": round(float(np.mean(st.pad_waste)), 4)
                if st.pad_waste else 0.0,
                "queue_depth": st.queue_depth_max,
                "serve_retraces": st.retraces,
                "serve_steady_compiles": st.steady_compiles,
                "serve_warm_s": round(st.warm_s, 3),
                "serve_dispatch_retries": st.retried,
                "serve_evictions": st.evicted,
            }
        return out

    def warm_summary(self) -> dict:
        """Warm-pool occupancy: resident entries, capacity, and per-spec
        prewarmed-pair counts (the ``pool`` telemetry source)."""
        pool = self._pool
        try:
            # the dispatcher mutates the LRU without the pool lock; a
            # scrape racing a resize retries next time
            items = list(pool._entries.items())
        except RuntimeError:
            items = []
        specs = {h: {"warm_buckets": len(e.warmed),
                     "pinned": bool(e.pinned),
                     "warm_s": round(e.warm_s, 3)}
                 for h, e in items}
        return {"entries": len(items), "max_entries": pool.max_entries,
                "builds": pool.builds, "evictions": pool.evictions,
                "specs": specs}

    def stream_summary(self) -> dict:
        """Per-stream telemetry (append counts and latencies) from the
        lazy StreamManager; empty when no stream was ever opened."""
        with self._lock:
            mgr = self._stream_mgr
        return mgr.summary() if mgr is not None else {}

    def cutover_stream(self, name: str, spec, checkpoint=None) -> dict:
        """Frozen-grid migration cutover for one of this pool's streams
        (the ``cutover`` protocol kind;
        :meth:`.streams.StreamManager.cutover`)."""
        with self._lock:
            mgr = self._stream_mgr
        if mgr is None:
            raise ServeError(f"stream {name!r} is not open on this pool; "
                             f"nothing to cut over")
        return mgr.cutover(name, spec, checkpoint=checkpoint)

    def kernel_summary(self) -> dict:
        """Kernel facts (the ``stats`` reply's ``kernels``): this
        process's launch count of each kernel wrapper, this pool's
        dispatches' launches by bucket (counted on its dispatcher thread:
        a sibling pool in the process adds none), the nvcc processes this process
        started (a replica that starts after its siblings built the
        kernels starts none) and, on a card, its memory: this process's
        allocated and reserved bytes and the card's free and total
        (``torch.cuda.mem_get_info``, every process on it together)."""
        from ..ops import _build

        with self._lock:
            by_bucket = {k: {str(b): n for b, n in sorted(v.items())}
                         for k, v in self._launches_by_bucket.items()}
        out = {"launches": _launch_counts(),
               "launches_by_bucket": by_bucket,
               "nvcc_starts": _build.nvcc_starts}
        dev = self.mesh.local_device
        if dev.type == "cuda":
            import torch

            free, total = torch.cuda.mem_get_info(dev)
            out["memory"] = {
                "allocated": int(torch.cuda.memory_allocated(dev)),
                "reserved": int(torch.cuda.memory_reserved(dev)),
                "card_free": int(free), "card_total": int(total)}
        return out

    def health_summary(self) -> dict:
        """The replica's own liveness facts (the ``stats`` / ``telemetry``
        kinds)."""
        with self._lock:
            closed = self._closed
        alive = self._dispatcher.is_alive() and self._demux_thread.is_alive()
        state = "closed" if closed else ("healthy" if alive else "failed")
        return {"state": state, "dispatcher_alive": bool(alive),
                "closed": bool(closed)}

    def telemetry_snapshot(self) -> dict:
        """One publisher snapshot (the ``telemetry`` protocol kind)."""
        return self.telemetry.snapshot()

    def telemetry_rollup(self) -> dict:
        """This pool's own single-replica aggregator rollup (the shape a
        fleet's rollup has); the aggregator lives across calls so rates
        see a real window between scrapes."""
        from ..obs import telemetry as telemetry_mod

        with self._lock:
            agg = self._metrics_agg
            if agg is None:
                agg = self._metrics_agg = telemetry_mod.TelemetryAggregator()
        health = self.health_summary()
        agg.ingest("self", self.telemetry.snapshot(),
                   health={"state": health["state"], "misses": 0,
                           "breaker_open": False})
        return agg.rollup()

    def metrics_text(self) -> str:
        """Prometheus text-format exposition of this pool's own rollup
        (the ``metrics`` protocol kind)."""
        from ..obs import promfmt

        return promfmt.render(self.telemetry_rollup())

    def save_report(self, path) -> str:
        """Write the pool's telemetry as a RunReport artifact: ``obs
        summarize`` prints it, ``obs compare`` / ``obs gate`` band its SLO
        metrics, ``obs trace`` renders the per-request spans."""
        return self.report().save(path)

    def report(self):
        from ..obs.report import RunReport

        with self._lock:
            timeline = list(self._timeline)
            st = self._stats
            total_s = ((st.t_last - self._t0)
                       if st.t_last is not None else 0.0)
        meta = {
            "kind": "serve",
            "platform": ("gpu" if self.mesh.local_device.type == "cuda"
                         else "cpu"),
            "n_devices": self.n_devices,
            "mesh_shape": {k: int(v) for k, v in self.mesh.shape.items()},
            "buckets": list(self._buckets),
            "max_queue_depth": int(self.config.max_queue_depth),
            "coalesce_window_s": float(self.config.coalesce_window_s),
            "extra_metrics": self.slo_summary(),
        }
        rep = RunReport(meta=meta, total_s=total_s)
        rep.timeline = sorted(timeline, key=lambda e: e.get("t0", 0.0))
        return rep

    # -- lifecycle ----------------------------------------------------------
    def close(self, drain: bool = True) -> None:
        """Shut down: ``drain=True`` serves everything already admitted
        (new submissions raise ServeClosed), ``drain=False`` fails pending
        requests with ServeClosed."""
        doomed = []
        with self._cond:
            if self._closed:
                return
            self._closed = True
            if not drain:
                for q in self._queues.values():
                    while q:
                        doomed.append(q.popleft())
                        self._pending -= 1
            self._cond.notify_all()
        for p in doomed:
            p.fut.set_exception(ServeClosed("pool closed"))
        # bounded joins: a wedged dispatcher surfaces as a note, never a
        # caller hung in close() forever
        self._dispatcher.join(_SHUTDOWN_JOIN_S)
        if self._dispatcher.is_alive():
            flightrec.note("serve_close_join_timeout", thread="dispatcher",
                           timeout_s=_SHUTDOWN_JOIN_S)
        self._demux_q.put(_STOP)
        self._demux_thread.join(_SHUTDOWN_JOIN_S)
        if self._demux_thread.is_alive():
            flightrec.note("serve_close_join_timeout", thread="demux",
                           timeout_s=_SHUTDOWN_JOIN_S)
        if self._stream_mgr is not None:
            self._stream_mgr.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
