"""Per-module policy tables the rules cross-check against (port of
``fakepta_tpu.analysis.policy``).

The port's contracts written down as data rather than prose: which modules
are sanctioned host-float64 stages and which may store bfloat16, which
mesh axis names exist, which functions make up the sampler's device step,
which modules own a raw clock, which queues are bounded by an outside
invariant, which metric names exist, where dispatch knobs and scenario
literals may live, and the lock order of the serving stack. Every table is
derived from the port's own modules, not renamed from the JAX package's.

Keep this file boring: plain dicts and tuples, no imports from the rest of
the package, so rules and tests can read it without importing torch.
"""

from __future__ import annotations

# Mesh axis names: a copy of fakepta_tpu_torch/parallel/mesh.py's AXES
# (REAL_AXIS, PSR_AXIS, TOA_AXIS), because the analyzer never imports the
# package under analysis; the tests pin the two equal. The port's
# collectives take no axis name: its axes are read as ``mesh.shape[...]``
# keys, which the mesh-axis-contract rule checks against these.
MESH_AXES = ("real", "psr", "toa")

# Module-level constant names that resolve to a declared axis.
MESH_AXIS_CONSTANTS = ("REAL_AXIS", "PSR_AXIS", "TOA_AXIS")

# dtype policy: repo-relative posix paths -> "host-f64" for modules whose
# float64 use is sanctioned by design. Everything else under the library
# prefix defaults to "device-f32", where a float64 marker is a finding
# unless its line carries a pragma with the reason; paths outside the
# library (tests, examples, benchmarks, chip_smoke.py) are exempt, their
# float64 oracles are the point. parallel/montecarlo.py has NO entry: it
# is the device path, and each of its host-f64 stages carries its own
# pragma.
DTYPE_POLICY = {
    # one-off host staging: ephemeris element propagation, CGW phase
    # references, pixel geometry, Kepler solves, the facade's f64 tables
    "fakepta_tpu_torch/ephemeris.py": "host-f64",
    "fakepta_tpu_torch/models/cgw.py": "host-f64",
    "fakepta_tpu_torch/ops/healpix.py": "host-f64",
    "fakepta_tpu_torch/ops/kepler.py": "host-f64",
    "fakepta_tpu_torch/utils/io.py": "host-f64",
    # the ORF templates and their Cholesky factors are host f64; on the
    # float64 path the GWB draws run at float64 on the device as well
    "fakepta_tpu_torch/ops/gwb.py": "host-f64",
    # the facade and the batch builder are the host-f64 staging layer
    # (absolute TOAs, noisedict variances), and a float64 pulsar keeps
    # float64 device tensors end to end (the float64 path)
    "fakepta_tpu_torch/fake_pta.py": "host-f64",
    "fakepta_tpu_torch/batch.py": "host-f64",
    # the statistics layer: host numpy analysis (optimal statistic, ORF
    # fits) around small torch helpers whose dtype follows the inputs,
    # float64 on the float64 path
    "fakepta_tpu_torch/correlated_noises.py": "host-f64",
    # the Fourier bases and white-noise draws take the batch dtype, float64
    # on the float64 path; their phase arguments are staged at float64
    "fakepta_tpu_torch/ops/fourier.py": "host-f64",
    "fakepta_tpu_torch/ops/white.py": "host-f64",
    # the statistic kernels' wrappers and plain versions take a float64
    # batch's rows, tables and weights at float64 (fpt_binned_corr_f64,
    # fpt_project_f64), as the JAX kernels compute at float64 operands
    "fakepta_tpu_torch/ops/binned_corr.py": "host-f64",
    "fakepta_tpu_torch/ops/megakernel.py": "host-f64",
    # the key tree draws float64 normals and uniforms bit for bit as
    # jax.random does under x64 (erfinv_f64, _uniform64)
    "fakepta_tpu_torch/utils/rng.py": "host-f64",
    # the observability layer is host telemetry: wall-clock floats and
    # JSON serialization, never device tensors
    "fakepta_tpu_torch/obs/__init__.py": "host-f64",
    "fakepta_tpu_torch/obs/metrics.py": "host-f64",
    "fakepta_tpu_torch/obs/timing.py": "host-f64",
    "fakepta_tpu_torch/obs/report.py": "host-f64",
    "fakepta_tpu_torch/obs/cli.py": "host-f64",
    "fakepta_tpu_torch/obs/__main__.py": "host-f64",
    "fakepta_tpu_torch/obs/trace.py": "host-f64",
    "fakepta_tpu_torch/obs/memwatch.py": "host-f64",
    "fakepta_tpu_torch/obs/flightrec.py": "host-f64",
    "fakepta_tpu_torch/obs/gate.py": "host-f64",
    # the detection statistics' host layers: operator precompute (ORF
    # templates, pair counts, noise weighting) is one-off f64 staging, and
    # the facade and CLI reduce packed lanes with host numpy
    "fakepta_tpu_torch/detect/operators.py": "host-f64",
    "fakepta_tpu_torch/detect/run.py": "host-f64",
    "fakepta_tpu_torch/detect/cli.py": "host-f64",
    # inference: the facade and CLI reduce packed likelihood lanes on the
    # host and stage theta grids at f64
    "fakepta_tpu_torch/infer/run.py": "host-f64",
    "fakepta_tpu_torch/infer/cli.py": "host-f64",
    # sampling: the float64 warm start (data -> Woodbury moments ->
    # Newton / Laplace on the host CPU) and the host diagnostics finishers;
    # the chain's device step (ops/mcmc.py) runs at the batch dtype
    "fakepta_tpu_torch/sample/run.py": "host-f64",
    "fakepta_tpu_torch/sample/model.py": "host-f64",
    "fakepta_tpu_torch/sample/cli.py": "host-f64",
    "fakepta_tpu_torch/sample/factorized.py": "host-f64",
    # the serve protocol codec stages JSON TOA blocks and theta grids as
    # host f64 arrays
    "fakepta_tpu_torch/serve/cli.py": "host-f64",
    # streaming: append-vs-restage is certified as an f64 oracle, so the
    # stream's device moments, the rolling OS and the refresher's warm
    # start run at float64 when the stream dtype is (the default)
    "fakepta_tpu_torch/stream/state.py": "host-f64",
    "fakepta_tpu_torch/stream/refresh.py": "host-f64",
    "fakepta_tpu_torch/stream/bench.py": "host-f64",
    "fakepta_tpu_torch/detect/streaming.py": "host-f64",
}
DTYPE_DEFAULT_LIBRARY = "device-f32"
DTYPE_EXEMPT = "exempt"

# bf16-storage policy (mixed-precision-cast): library modules sanctioned
# to store float32 tensors as bfloat16, the storage-halving /
# f32-accumulate precision modes: the binned-correlation kernels' bf16
# operands, the megakernel's bf16 bases and coefficients, the engine's
# bases/stats casts. A bfloat16 cast anywhere else in the library changes
# realization streams without a tolerance certification.
BF16_STORAGE_MODULES = (
    "fakepta_tpu_torch/ops/binned_corr.py",
    "fakepta_tpu_torch/ops/megakernel.py",
    "fakepta_tpu_torch/parallel/montecarlo.py",
)

# The sampler's device step (host-sync-in-jit's chain-loop clause), the
# port's form of the JAX sampler's lax.scan bodies: module path ->
# qualified names (``Class.method``, ``outer.inner``) of the functions a
# segment runs once per MCMC step or per leapfrog step. A segment enqueues
# all of their work without one host sync (ops/mcmc.py docstring), so any
# sync inside them re-serializes every step behind a device round trip.
DEVICE_STEP_FUNCTIONS = {
    "fakepta_tpu_torch/ops/mcmc.py": (
        "fixed_sum", "fixed_matvec", "tempered", "leapfrog",
        "transition_draws", "hmc_step", "hmc_transition",
        "swap_from_uniforms", "swap_permutation", "apply_permutation",
    ),
    "fakepta_tpu_torch/sample/run.py": (
        "SamplingRun._pulsar_rows", "SamplingRun._vg",
        "SamplingRun._transition_draws", "SamplingRun._segment",
    ),
}

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
COLLECTIVE_DIVERGENCE_MODULES = ()

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


def dtype_policy_for(rel: str) -> str:
    """Resolve the dtype policy for a repo-relative posix path."""
    if rel in DTYPE_POLICY:
        return DTYPE_POLICY[rel]
    if is_library(rel):
        return DTYPE_DEFAULT_LIBRARY
    return DTYPE_EXEMPT


def is_library(rel: str) -> bool:
    return any(rel.startswith(p) for p in LIBRARY_PREFIXES)
