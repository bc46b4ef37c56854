"""fakepta_tpu_torch.serve: the warm-pool serving layer and its
microbatch coalescing scheduler (port of ``fakepta_tpu.serve``, its first
half).

The request-shaped front door to the ensemble engine: many small user
requests coalesce into one padded chunk dispatch over a warm pool of
simulators, each request riding its own RNG lane, so a response is
bit-identical to the same request served alone at its bucket. Backpressure
(:class:`ServeBusy`), per-request deadlines (:class:`ServeTimeout`),
flight-recorder failure notes and SLO telemetry (``serve_p50_ms`` /
``serve_p99_ms`` / ``serve_qps_per_chip``, ``coalesce_factor``,
``pad_waste_frac``) are part of the lane. The pool serves on the card
unless ``device="cpu"`` is given.

Ported here: the request and spec surface (:mod:`.spec`), the warm pool
(:mod:`.pool`), the scheduler (:mod:`.scheduler`), the consistent-hash
router (:class:`HashRing`), the fleet health plane
(:class:`HealthMonitor`) and autoscaler policy (:class:`Autoscaler`),
the one-pool load generator (:func:`run_loadgen`) and the CLI. The fleet
(``ServeFleet``, ``LocalReplica``, ``SocketReplica``, sampling sessions),
the ``StreamManager`` and the fleet, elastic and gateway load generators
are ROADMAP Queue 1 item 11b slices 4 and 5.

Embeddable surface::

    from fakepta_tpu_torch.serve import ArraySpec, ServePool, SimRequest
    pool = ServePool()                       # the card; device="cpu" here
    res = pool.serve(SimRequest(spec=ArraySpec(npsr=20), n=32, seed=7))
    pool.close()

CLI: ``python -m fakepta_tpu_torch.serve loadgen|stdin|socket|replica``.
"""

from .autoscale import AutoscaleConfig, Autoscaler
from .health import HealthConfig, HealthMonitor
from .loadgen import run_loadgen
from .pool import PoolEntry, WarmPool
from .router import HashRing
from .scheduler import ServeConfig, ServePool, ServeResult
from .spec import (DEFAULT_BUCKETS, AppendRequest, ArraySpec, InferRequest,
                   OSRequest, ServeBusy, ServeClosed, ServeError,
                   ServeTimeout, SimRequest, StreamRequest, curn_grid_spec)

__all__ = [
    "DEFAULT_BUCKETS", "AppendRequest", "ArraySpec", "AutoscaleConfig",
    "Autoscaler", "HashRing", "HealthConfig", "HealthMonitor",
    "InferRequest", "OSRequest", "PoolEntry", "ServeBusy", "ServeClosed",
    "ServeConfig", "ServeError", "ServePool", "ServeResult", "ServeTimeout",
    "SimRequest", "StreamRequest", "WarmPool", "curn_grid_spec",
    "run_loadgen",
]
