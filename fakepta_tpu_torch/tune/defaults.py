"""Hand-set dispatch-knob defaults (port of ``fakepta_tpu.tune.defaults``):
the one place literal dispatch-knob values live in the port's library
code.

The entries of the JAX package's stdlib-only table that the port's engine
and sampler read, value for value; no imports beyond the stdlib. One name
reads differently: :data:`DEFAULT_PATH` names the port's ``"einsum"``
path, the counterpart of the JAX package's ``"xla"`` path. The stream
and telemetry knobs are here with the modules that read them
(:mod:`..stream`, :mod:`..obs.telemetry`), the tuner's constants with
the tuner (:mod:`.search`, :mod:`.store`, :mod:`.model`), and the serve
ladders and the fleet lifecycle knobs (:mod:`..serve.spec`,
:mod:`..serve.health`, :mod:`..serve.autoscale`), and the gateway's knobs
with the modules that read them (:mod:`..gateway`, the stream cutover of
:mod:`..serve.streams`).
"""

from __future__ import annotations

# --- engine dispatch knobs (EnsembleSimulator.run) -------------------------

#: default realizations per chunk dispatch (run(chunk=...)'s hand-set value)
DEFAULT_CHUNK = 1024

#: default in-flight chunk depth for the async pipeline (0 = serial loop);
#: the sampler's segment pipeline takes the same default
DEFAULT_PIPELINE_DEPTH = 2

#: default statistic path when the constructor picked none ('einsum' |
#: 'fused' | 'mega'); the per-path precision default stays with the path.
#: The JAX package's value is "xla", its plain XLA path, which is the
#: port's "einsum" path (the mapping {"xla": "einsum"}). The port's
#: EnsembleSimulator keeps "fused" as its constructor default (bf16
#: operands), a divergence ROADMAP Queue 3 records.
DEFAULT_PATH = "einsum"

# --- serve dispatch knobs (the tuner's bucket model reads them) ------------

#: default microbatch bucket ladder: geometric with ratio 2, so padding a
#: cohort up to the next bucket wastes < 50% of slots in the worst case
DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)

#: the ladder ratio the bucket model assumes (mean pad waste ~
#: (ratio-1)/(2*ratio) under uniform cohort sizes)
BUCKET_RATIO = 2

#: default bucket ladder for the FLEET load benchmark: deliberately short,
#: so the warmup bill is one kernel configuration per (spec, bucket) and
#: small-request cohorts cap early (the solo loadgen covers ladder breadth)
DEFAULT_FLEET_BUCKETS = (16, 32)

# --- fleet lifecycle knobs (serve/health.py, serve/autoscale.py) -----------

#: heartbeat probe period per replica (seconds); the monitor probes every
#: live replica on this cadence while it is healthy
HEARTBEAT_PERIOD_S = 1.0

#: per-probe deadline: a probe that has not answered by now is a MISS;
#: well under the period so misses accumulate quickly
HEARTBEAT_DEADLINE_S = 0.25

#: consecutive probe misses before a replica is SUSPECT (breaker opens:
#: new routes drain away while probing continues with backoff)
HEARTBEAT_SUSPECT_AFTER = 2

#: consecutive probe misses before a suspect replica is WEDGED (still
#: breakered, still probed: a wedged replica can come back)
HEARTBEAT_WEDGED_AFTER = 4

#: consecutive probe successes before the breaker closes again
BREAKER_CLOSE_AFTER = 2

#: suspect-probe exponential backoff: first retry delay and its cap
BREAKER_BACKOFF_BASE_S = 0.5
BREAKER_BACKOFF_CAP_S = 8.0

#: autoscaler: per-replica throughput a healthy fleet should sustain;
#: demand above ``alive * target`` asks for one more replica
AUTOSCALE_TARGET_QPS_PER_REPLICA = 32.0

#: autoscaler hysteresis band (fractional): scale DOWN only when demand
#: sits below ``(1 - band)`` of the post-shrink capacity
AUTOSCALE_HYSTERESIS = 0.25

#: autoscaler p99 latency trip wires (milliseconds): above the high mark
#: scale up regardless of qps; scale down only below the low mark
AUTOSCALE_P99_HIGH_MS = 2000.0
AUTOSCALE_P99_LOW_MS = 500.0

#: cooldown between scale actions (seconds)
AUTOSCALE_COOLDOWN_S = 30.0

# --- streaming dispatch knobs (stream/) ------------------------------------

#: append-block bucket ladder: an appended TOA block pads up to the
#: smallest rung >= its width, so every single-epoch append of a P-pulsar
#: array (a handful of TOAs per pulsar) builds ONE small-block kernel and
#: reuses it forever. The same rungs size the ECORR epoch capacity and
#: the host store
STREAM_BLOCK_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)

#: growth ratio past the top ladder rung AND for the stream's storage /
#: ECORR-epoch capacity rungs: capacities only ever move to the next
#: power-of-ratio rung, so a stream that doubles its data rebuilds
#: O(log growth) times total, not O(appends)
STREAM_GROWTH_RATIO = 2

#: posterior-refresh scheduling (stream/refresh.py RefreshPolicy): a
#: refresh is due after this many appended TOA blocks since the last one...
REFRESH_EVERY_APPENDS = 4

#: ...or earlier, when the rolling detection statistic moved this much in
#: |SNR| since the last refresh (0 disables the SNR trigger; streams
#: without a ``watch`` statistic fall back to the epoch-count trigger)
REFRESH_MIN_SNR_GAIN = 0.5

#: per-frequency incremental refresh (stream/refresh.py
#: FactorizedRefresher): a lane counts as TOUCHED by an append when its
#: data-moment block moved by more than this relative amount
#: (``||dT_new - dT_old||_F / ||dT_old||_F`` over the lane's columns)
FS_TOUCH_TOL = 1e-3

# --- telemetry-plane knobs (obs/telemetry.py) -------------------------------

#: bounded snapshot ring per replica publisher (and per replica inside the
#: aggregator)
TELEMETRY_RING_SIZE = 64

#: scrape every Nth successful heartbeat probe (1 = every probe); the
#: scrape rides the heartbeat's connection, so this is the only
#: telemetry-frequency control
TELEMETRY_SCRAPE_EVERY = 1

#: rollup window (seconds of per-replica snapshot history) used for rates
#: (qps) and the append-latency regression baseline
TELEMETRY_WINDOW_S = 30.0

#: alert thresholds: p99 request latency over SLO, consecutive heartbeat
#: misses, append-latency regression multiple over the window baseline,
#: and the peak device-memory watermark fraction of the per-device budget
ALERT_P99_SLO_MS = 2000.0
ALERT_HEARTBEAT_MISS_STREAK = 3
ALERT_APPEND_REGRESSION_X = 3.0
ALERT_HBM_WATERMARK_FRAC = 0.9

#: per-device working-set budget when the backend exposes no memory limit
#: (the CPU): the tuner's residency budget there and the hbm_watermark
#: alert's default denominator
DEFAULT_BYTES_BUDGET = 2 << 30

# --- gateway knobs (gateway/) ----------------------------------------------

#: total in-flight requests the gateway will hold across ALL tenants: the
#: denominator of every tenant's weighted fair share; past it every
#: admission is a per-tenant 429 with a retry hint
GATEWAY_MAX_INFLIGHT = 128

#: default tenant weight when a Tenant does not set one (fair shares are
#: weight / sum(weights) of GATEWAY_MAX_INFLIGHT, floored at one slot)
GATEWAY_DEFAULT_WEIGHT = 1

#: floor for per-tenant retry_after_s hints (the hint scales with the
#: tenant's own recent latency, never below this)
GATEWAY_RETRY_MIN_S = 0.02

#: ...and its cap (a cold tenant with no latency history gets the floor;
#: a backed-up one never waits longer than this before re-probing)
GATEWAY_RETRY_CAP_S = 5.0

#: per-tenant completed-latency ring (the retry-hint / qps window)
GATEWAY_LATENCY_RING = 128

#: LRU bound on the single-flight table: when this many flights are
#: already open, new keys bypass coalescing (dispatch directly, counted
#: ``gateway.coalesce_bypass``) rather than grow the table without bound
GATEWAY_SINGLEFLIGHT_CAP = 512

#: LRU bound on the result store's in-memory payload cache (decoded npz
#: payloads; the on-disk store is the durable plane)
GATEWAY_RESULT_CACHE_CAP = 256

#: bound on on-disk result-store entries: past it ``put`` evicts the
#: oldest entries (index order) and unlinks their payload files
GATEWAY_STORE_CAP = 4096

#: result-store schema tag + version; entries written by a different
#: version are ignored (loud miss-and-recompute, never reinterpreted).
#: The JAX package's tag and version: an entry one package wrote is
#: still refused by the other, through its fingerprint
GATEWAY_STORE_SCHEMA = "fakepta_tpu.gateway/1"
GATEWAY_STORE_VERSION = 1

#: environment variable naming the gateway result-store directory; unset
#: falls back to a ``gateway/`` dir beside the tune store
GATEWAY_DIR_ENV = "FAKEPTA_TPU_GATEWAY_DIR"

#: result-store index file name (inside the gateway directory)
GATEWAY_INDEX_FILENAME = "results.json"

#: cutover oracle tolerance: max relative drift between the restaged
#: moments and a fresh restage of the NEW state before the swap aborts
GATEWAY_CUTOVER_RTOL = 1e-10

# --- sampler knobs (sample/) -----------------------------------------------

#: factorized free-spectrum sampling (sample/factorized.py): bins per
#: lane. 1 = fully per-frequency (most lanes, smallest chains); wider
#: blocks amortize per-lane fixed cost when lane count outruns the fleet.
#: The factorization itself is exact for any block width on a regular
#: grid, so this is purely a throughput knob.
FS_LANE_BINS = 4

# --- tuner constants (tune/) ------------------------------------------------

#: store schema tag + version; entries written by a different version are
#: ignored (never silently reinterpreted) and the tuner re-searches. The
#: JAX package's tag and version: the two stores share one file layout
STORE_SCHEMA = "fakepta_tpu.tune/1"
STORE_VERSION = 1

#: environment variable naming the TunedConfig store directory; when unset
#: the store falls back to ``~/.cache/fakepta_tpu_torch/`` so warm starts
#: survive process boundaries by default
TUNE_DIR_ENV = "FAKEPTA_TPU_TUNE_DIR"

#: store file name (inside the tune directory)
STORE_FILENAME = "tuned.json"

#: measured-refinement budget: the search stops issuing probes past this
#: wall-clock spend and keeps the best candidate probed so far (the
#: hand-set default candidate is always probed first, so a budget-expired
#: search still returns a well-defined "no worse than hand-set" choice)
PROBE_BUDGET_S = 120.0

#: per-probe watchdog deadline (a probe that hangs in a drain is aborted
#: and scored as failed instead of killing the search)
PROBE_TIMEOUT_S = 30.0

#: measured chunks per probe (beyond the warm chunk); single digits by
#: design: probes are throughput estimates, not runs
PROBE_CHUNKS = 2

#: pipeline depths the model-first frontier offers the prober (the same
#: kernels at every depth, so extra depths cost no builds)
DEPTH_CANDIDATES = (0, 2, 4)

#: fraction of per-device memory the residency model may plan into
#: (headroom for the caching allocator, collectives and host staging)
HBM_FRACTION = 0.6
