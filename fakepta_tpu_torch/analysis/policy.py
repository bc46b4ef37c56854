"""Per-module policy tables the rules cross-check against (port of
``fakepta_tpu.analysis.policy``).

The port's contracts written down as data rather than prose: which modules
own a raw clock, which queues are bounded by an outside invariant, which
metric names exist, where dispatch knobs and scenario literals may live,
and the lock order of the serving stack. Every table is derived from the
port's own modules, not renamed from the JAX package's.

Keep this file boring: plain dicts and tuples, no imports from the rest of
the package, so rules and tests can read it without importing torch.
"""

from __future__ import annotations

# timing-discipline allowlist: library modules sanctioned to read raw
# clocks. obs/timing.py IS the sanctioned clock (now/Timer/span route
# through it); obs/flightrec.py reads perf_counter directly because
# obs/metrics.py imports it, and obs/timing.py imports metrics, so the
# recorder cannot import timing without a cycle. A bare clock read
# anywhere else in the library is a measurement the telemetry artifacts
# never see.
TIMING_MODULES = (
    "fakepta_tpu_torch/obs/timing.py",
    "fakepta_tpu_torch/obs/flightrec.py",
)

# unbounded-queue allowlist: library modules whose unbounded queue is
# bounded by an EXTERNAL invariant. pipeline.py's ThreadWriter queue is the
# one case: the run loop's ring holds chunk i's dispatch until chunk
# i - depth has drained, so the queue never holds more than depth + 1
# drains (ThreadWriter docstring).
UNBOUNDED_QUEUE_MODULES = (
    "fakepta_tpu_torch/parallel/pipeline.py",
)

# unbounded-cache allowlist (cache-named dicts bounded by an invariant the
# AST cannot see). Empty: every cache of the port carries its bound
# locally.
UNBOUNDED_CACHE_MODULES = ()

# unbounded-thread-join allowlist. Empty: every shutdown join of the port
# carries a timeout.
UNBOUNDED_JOIN_MODULES = ()

# unbounded-socket-io allowlist. Empty: the serve socket server sets a
# per-connection idle timeout and the fleet's socket client stamps
# timeouts at connect.
SOCKET_IO_MODULES = ()

# swallowed-exception allowlist: modules whose broad silent handlers are
# the design. obs/flightrec.py is the crash recorder: its dump runs while
# another exception is being handled, and a failed dump must not mask it.
# obs/memwatch.py probes allocator statistics that may raise anything on
# an unusual device; telemetry there is best effort, and an unstatted
# device is the recorded outcome (the field is absent).
SWALLOWED_EXCEPT_MODULES = (
    "fakepta_tpu_torch/obs/flightrec.py",
    "fakepta_tpu_torch/obs/memwatch.py",
)

# metric-name discipline (rules/metric_names.py): every library call to
# the obs emitters passes a LITERAL name from this registry that matches
# METRIC_NAME_RE. A copy of fakepta_tpu_torch/obs/metrics.py's registry,
# because the analyzer never imports the package under analysis; the
# tests pin the two equal.
METRIC_NAME_RE = r"^[a-z][a-z0-9_.]*$"
METRIC_NAMES = (
    "faults.degradations", "faults.injected", "faults.retries",
    "faults.rollbacks",
    "fleet.breaker_opens", "fleet.drains", "fleet.heartbeat_misses",
    "fleet.joins", "fleet.scale_events",
    "gateway.auth_failures", "gateway.cache_rejects",
    "gateway.coalesce_bypass", "gateway.coalesced",
    "gateway.cutover_aborts", "gateway.cutovers", "gateway.hits",
    "gateway.requests", "gateway.store_evictions", "gateway.store_puts",
    "gateway.throttles",
    "kernels.build_s",
    "obs.chunks", "obs.peak_hbm_bytes",
    "pipeline.d2h_async", "pipeline.h2d_prefetch",
    "sample.lane_runs", "sample.segments_done",
    "serve.append_latency_s", "serve.stream_requests",
    "stream.appends", "stream.compiles", "stream.detections",
    "stream.fs_bins_touched", "stream.fs_lanes_refreshed",
    "stream.fs_refreshes",
    "stream.promotions", "stream.rebuckets", "stream.recompiles",
    "stream.refresh_gate_holds", "stream.refresh_gate_opens",
    "stream.refresh_skips", "stream.refreshes", "stream.replays",
    "telemetry.alerts", "telemetry.scrape_errors", "telemetry.scrapes",
)

# metric-name-discipline allowlist: obs/metrics.py defines the emitters
# (its helpers forward caller-supplied names) and obs/timing.py derives
# ``timer.<label>`` names from its Timer labels.
METRIC_NAME_MODULES = (
    "fakepta_tpu_torch/obs/metrics.py",
    "fakepta_tpu_torch/obs/timing.py",
)

# hardcoded-dispatch-knob allowlist: the one library module where literal
# dispatch-knob values (rt, pipeline_depth, bucket ladders) may live.
DISPATCH_KNOB_MODULES = (
    "fakepta_tpu_torch/tune/defaults.py",
)

# the only modules where flagship-scale ArraySpec / PulsarBatch.synthetic
# literals may live (unregistered-scenario): the scenario registry, and
# tune/defaults.py's probe shapes, which are tuning inputs, not datasets.
SCENARIO_SPEC_MODULES = (
    "fakepta_tpu_torch/scenarios/registry.py",
    "fakepta_tpu_torch/tune/defaults.py",
)

# the npsr floor separating "a unit-test fixture" from "a dataset claim"
SCENARIO_NPSR_FLOOR = 64

# ---------------------------------------------------------------------------
# whole-program concurrency policy (concurrency.py)
# ---------------------------------------------------------------------------

# Canonical lock names for acquisitions that reach another object's lock
# through a duck-typed attribute (``self.fleet._lock`` in the health
# monitor IS the fleet's lock). Keys: the lock as observed at the
# acquisition site (``<OwnerClass>.<attr path>``).
LOCK_ALIASES = {
    "HealthMonitor.fleet._lock": "ServeFleet._lock",
    "SamplingSession.fleet._lock": "ServeFleet._lock",
    "LocalReplica.pool._lock": "ServePool._lock",
    "LocalReplica.pool._cond": "ServePool._lock",
}

# The canonical acquisition order: a thread may take a lock only while
# holding locks EARLIER in this tuple. Locks not listed are held to cycle
# detection alone. The port's own leaf locks (ops/_build._LOCK,
# obs/memwatch._SIZES_LOCK, obs/telemetry._live_lock, ThreadWriter's
# _exc_lock) are never held while another lock is taken or taken under
# one (`graph --dot` shows no edge at them), so they stay unranked.
LOCK_ORDER = (
    "Gateway._lock",           # tenant admission + single-flight table
                               # (outermost; released before fleet/store)
    "SocketReplica._lock",     # transport: pending-futures map
    "ServePool._lock",         # scheduler: admission queues + stats
    "StreamManager._lock",     # stream registry
    "ServeFleet._lock",        # router: ring membership + SLO stats
    "HealthMonitor._lock",     # health counters (probes run lock-free)
    "ResultStore._io_lock",    # gateway index-file writes; over _lock
    "ResultStore._lock",       # gateway result store: index + payload LRU
    "obs/flightrec._dump_lock",  # flight-recorder dump serialization
)

# Duck-typed attribute -> class hints where the constructor assigns a bare
# parameter (``self.fleet = fleet``). Keys: (owner class, attribute).
ATTR_CLASS_HINTS = {
    ("HealthMonitor", "fleet"): "ServeFleet",
    ("SamplingSession", "fleet"): "ServeFleet",
    ("Autoscaler", "fleet"): "ServeFleet",
}

# Engine-dispatch method names that block for device work; under a lock
# they serialize every sibling behind it (blocking-under-lock).
BLOCKING_DISPATCH_METHODS = ("run", "warm_start", "prewarm", "ensure_warm")

# Constructors whose __init__ does heavy device or IO work (checkpoint
# replay, process spawn + banner handshake).
BLOCKING_CONSTRUCTORS = ("StreamState", "SocketReplica", "ServePool")

# Per-module exemptions for the whole-program rules (prefer a line pragma
# with its justification).
BLOCKING_UNDER_LOCK_MODULES = ()
SHARED_STATE_MODULES = ()

# Method names too generic for class-hierarchy call resolution: an
# untyped ``x.get()`` must not resolve to every class defining ``get``.
GENERIC_METHOD_NAMES = frozenset((
    "append", "extend", "add", "get", "put", "pop", "popleft", "items",
    "keys", "values", "update", "copy", "clear", "close", "join", "wait",
    "result", "set", "is_set", "count", "index", "insert", "remove",
    "sort", "read", "write", "flush", "note", "stats", "start", "stop",
    "run", "send", "recv", "encode", "decode", "format", "split", "strip",
    "exists", "open", "name", "parts", "todict", "acquire", "release",
    "mean", "sum", "std", "min", "max", "reset", "kill", "report",
))

# Library code prefix: the library-only rules and the whole-program pass
# read only these modules.
LIBRARY_PREFIXES = ("fakepta_tpu_torch/",)

# Directory names skipped when *walking* directories (explicit file
# arguments always win): fixture corpora are dirty on purpose.
EXCLUDE_DIR_NAMES = ("__pycache__", "fixtures_analysis", ".git")


def is_library(rel: str) -> bool:
    return any(rel.startswith(p) for p in LIBRARY_PREFIXES)
