"""fakepta_tpu_torch.serve: the warm-pool serving layer, its microbatch
coalescing scheduler and the fleet in front of it (port of
``fakepta_tpu.serve``).

The request-shaped front door to the ensemble engine: many small user
requests coalesce into one padded chunk dispatch over a warm pool of
simulators, each request riding its own RNG lane, so a response is
bit-identical to the same request served alone at its bucket. Backpressure
(:class:`ServeBusy`), per-request deadlines (:class:`ServeTimeout`),
flight-recorder failure notes and SLO telemetry (``serve_p50_ms`` /
``serve_p99_ms`` / ``serve_qps_per_chip``, ``coalesce_factor``,
``pad_waste_frac``) are part of the lane. The pool serves on the card
unless ``device="cpu"`` is given.

Horizontal scale-out: :class:`ServeFleet` puts a spec-hash
consistent-hash router (:class:`HashRing`) in front of N replicas
(:class:`LocalReplica` in process, :class:`SocketReplica` a subprocess on
its own card or sharing one): warm-pool affinity per spec shard,
saturation spillover, fleet-wide 429 aggregation, mid-flight failover
(bit-identical per RNG lane), a shared kernel build directory (a
replica's cold start builds nothing), and :class:`SamplingSession`\\ s
that migrate between replicas at segment-boundary checkpoints.

Fleet lifecycle: the :class:`HealthMonitor` heartbeat plane classifies
replicas healthy / suspect / wedged / dead with a circuit breaker;
elastic membership (:meth:`ServeFleet.join` / :meth:`ServeFleet.retire`
and the ``serve replica --register`` hello / adopt handshake); the
:class:`Autoscaler` turns the fleet SLO rollups into a target replica
count with hysteresis and cooldown.

Streaming ingestion: :class:`AppendRequest` / :class:`StreamRequest` feed
named :class:`..stream.StreamState` sessions through the pool's
:class:`StreamManager`, routed by the fleet with stream affinity (by
stream name, no saturation spillover) to the owning replica.

Embeddable surface::

    from fakepta_tpu_torch.serve import ArraySpec, ServePool, SimRequest
    pool = ServePool()                       # the card; device="cpu" here
    res = pool.serve(SimRequest(spec=ArraySpec(npsr=20), n=32, seed=7))
    pool.close()

    from fakepta_tpu_torch.serve import LocalReplica, ServeFleet
    fleet = ServeFleet([LocalReplica("r0"), LocalReplica("r1")])
    res = fleet.serve(SimRequest(spec=ArraySpec(npsr=20), n=32, seed=7))

CLI: ``python -m fakepta_tpu_torch.serve
loadgen|stdin|socket|replica|fleet``. :func:`run_gateway_loadgen` drives
a :class:`..gateway.Gateway` in front of in-process replicas.
"""

from .autoscale import AutoscaleConfig, Autoscaler
from .fleet import (FleetConfig, LocalReplica, ReplicaDead,
                    SampleSessionSpec, SamplingSession, ServeFleet,
                    SocketReplica)
from .health import HealthConfig, HealthMonitor
from .loadgen import (run_elastic_loadgen, run_fleet_loadgen,
                      run_gateway_loadgen, run_loadgen)
from .pool import PoolEntry, WarmPool
from .router import HashRing
from .scheduler import ServeConfig, ServePool, ServeResult
from .spec import (DEFAULT_BUCKETS, AppendRequest, ArraySpec, InferRequest,
                   OSRequest, ServeBusy, ServeClosed, ServeError,
                   ServeTimeout, SimRequest, StreamRequest, curn_grid_spec)
from .streams import StreamManager

__all__ = [
    "DEFAULT_BUCKETS", "AppendRequest", "ArraySpec", "AutoscaleConfig",
    "Autoscaler", "FleetConfig", "HashRing", "HealthConfig",
    "HealthMonitor", "InferRequest", "LocalReplica", "OSRequest",
    "PoolEntry", "ReplicaDead", "SampleSessionSpec", "SamplingSession",
    "ServeBusy", "ServeClosed", "ServeConfig", "ServeError", "ServeFleet",
    "ServePool", "ServeResult", "ServeTimeout", "SimRequest",
    "SocketReplica", "StreamManager", "StreamRequest", "WarmPool",
    "curn_grid_spec", "run_elastic_loadgen", "run_fleet_loadgen",
    "run_gateway_loadgen", "run_loadgen",
]
